"""Attention with int8 Q K^T (SageAttention recipe): kernel B6 and its plain
version.

Port of `flexam_tpu/ops/int8_attention.py`. The CUDA kernel lives in
`csrc/int8_attention.cu`. What the JAX wrapper does around its kernel is
done here in plain torch ops, step for step, by `quantize_qk`:

  * k is smoothed by its per-(batch, head) mean over all keys (those past
    k_len included), taken in fp32 and cast to k's dtype: softmax does not
    see the per-row constant this adds to the logits, and the centred keys
    quantize with less error;
  * q and k are quantized to int8 with one absmax/127 scale per (batch,
    head, block of rows), rounding half to even and clipping to +-127. The
    blocks are `_auto_block` rows (1,456 at 11,648 and 23,296 tokens, 1,344
    at 18,816), so they are part of the function: another grouping gives
    other numbers.

The kernel then takes int8 logits, dequantized by (q scale * k scale) *
(softmax scale * log2 e), an exp2 online softmax in fp32, and a P.V in v's
dtype: bf16, or fp32 on TF32 wgmma (the card's counterpart of the TPU's
default fp32 matmul precision) after a pre-pass that writes V^T rounded to
tf32 into a workspace allocated here.
`int8_attention_plain` repeats the same steps in torch over query chunks;
its int8 products are exact in fp32 (|s| <= 127^2 * D < 2^24) up to
D = 1024 as long as the matmul runs in full fp32 (on the card: TF32 off).
Above that its fp32 sums round; the kernel sums in s32, exact at any D, and
refuses no D for it. The quantization blocks stay `blk` rows by the whole
head dim, as in JAX.

Layout [B, L, H, D], bf16 or fp32, on the card any D that is a multiple of
128 (`flash_attention.attention_instance`; fp16 raises TypeError). A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain
version.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from flexam_tpu_torch.ops import build
from flexam_tpu_torch.ops.flash_attention import (DTYPES, LOG2E,
                                                  MASK_VALUE, check_inputs,
                                                  vt_workspace)

# kernel launches on CUDA tensors
launches = {"int8_attention": 0}


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _auto_block(n: int, hi: int = 1456, lo: int = 512,
                default: int = 1024) -> int:
    """Largest divisor of n in [lo, hi] that is a multiple of 16; else
    min(default, n rounded up to 128). (A copy of the JAX package's
    `ops/flash_attention._auto_block`, which sets the quantization blocks.)"""
    if n >= lo:
        for b in range(hi - hi % 16, lo - 1, -16):
            if n % b == 0:
                return b
    return min(default, _ceil_to(n, 128))


def quant_block(n: int) -> int:
    """Rows per quantization scale for a sequence of n rows."""
    return min(_auto_block(n), _ceil_to(n, 128))


def quantize_blocks(x: torch.Tensor, blk: int):
    """[B, L, H, D] -> (int8 [B, L, H, D], fp32 scales [B, H, ceil(L/blk)])
    with one absmax/127 scale per (batch, head, block of blk rows). Rows past
    L count as zeros, as the JAX wrapper pads them."""
    b, n, h, d = x.shape
    nb = -(-n // blk)
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, nb * blk - n)).view(b, nb, blk, h, d)
    scale = xf.abs().amax(dim=(2, 4)).clamp_min(1e-6) / 127.0   # [B, nb, H]
    q = torch.clamp(torch.round(xf / scale[:, :, None, :, None]), -127, 127)
    q = q.to(torch.int8).view(b, nb * blk, h, d)[:, :n]
    return q.contiguous(), scale.transpose(1, 2).contiguous()


def quantize_qk(q: torch.Tensor, k: torch.Tensor):
    """The wrapper's work before the kernel: (q8, q_scale_per_row [B, H, Lq],
    k8, k_scale_per_key [B, H, Lk]), k smoothed by its mean first."""
    lq, lk = q.shape[1], k.shape[1]
    k = k - k.float().mean(dim=1, keepdim=True).to(k.dtype)
    blq, blk = quant_block(lq), quant_block(lk)
    q8, qs = quantize_blocks(q, blq)
    k8, ks = quantize_blocks(k, blk)
    qs = qs.repeat_interleave(blq, dim=2)[:, :, :lq].contiguous()
    ks = ks.repeat_interleave(blk, dim=2)[:, :, :lk].contiguous()
    return q8, qs, k8, ks


def _dequant_factor(scale: Optional[float], d: int) -> float:
    return float((d ** -0.5 if scale is None else scale) * LOG2E)


def int8_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_len: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None,
                         q_chunk: int = 512) -> torch.Tensor:
    """B6's function in torch ops: the kernel's quantization, dequantized
    int8 logits, masking at k_len, exp2 softmax in fp32 with the
    probabilities cast to v's dtype before P.V, divided by the sum after."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    q8, qs, k8, ks = quantize_qk(q, k)
    c = torch.tensor(_dequant_factor(scale, d), dtype=torch.float32,
                     device=q.device)
    kf = k8.float().permute(0, 2, 3, 1)                 # [B, H, D, Lk]
    vf = v.float().transpose(1, 2)                      # [B, H, Lk, D]
    keep = None
    if k_len is not None:
        keep = (torch.arange(lk, device=q.device)[None, :]
                < k_len.to(q.device)[:, None])[:, None, None, :]
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    for a in range(0, lq, q_chunk):
        qf = q8[:, a:a + q_chunk].float().transpose(1, 2)   # [B, H, c, D]
        s = torch.matmul(qf, kf)                             # exact integers
        s = s * ((qs[:, :, a:a + q_chunk, None] * ks[:, :, None, :]) * c)
        if keep is not None:
            s = s.masked_fill(~keep, MASK_VALUE)
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        o = torch.matmul(p.to(v.dtype).float(), vf) / p.sum(dim=-1,
                                                           keepdim=True)
        out[:, a:a + q_chunk] = o.transpose(1, 2).to(v.dtype)
    return out


def int8_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   k_len: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """B6: attention over [B, L, H, D] with int8 Q K^T, bf16 or fp32; any
    key count."""
    if not q.is_cuda:
        return int8_attention_plain(q, k, v, k_len=k_len, scale=scale)
    build.refuse_autograd("int8_attention", q, k, v)
    k_len = check_inputs(q, k, v, k_len, "int8_attention", DTYPES)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    q8, qs, k8, ks = quantize_qk(q, k)
    out = torch.empty_like(q)
    tail = (qs.data_ptr(), ks.data_ptr(),
            k_len.data_ptr() if k_len is not None else None,
            b, h, lq, lk, d, _dequant_factor(scale, d),
            build.stream_handle(q))
    if q.dtype == torch.float32:
        # the pre-pass's output: V^T rounded to tf32
        vt = vt_workspace(v)
        err = build.library().flexam_int8_attention_f32(
            q8.data_ptr(), k8.data_ptr(), v.data_ptr(), vt.data_ptr(),
            out.data_ptr(), *tail)
    else:
        err = build.library().flexam_int8_attention(
            q8.data_ptr(), k8.data_ptr(), v.data_ptr(), out.data_ptr(),
            *tail)
    build.check(err, "int8_attention")
    launches["int8_attention"] += 1
    return out
