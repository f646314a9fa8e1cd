"""Attention dispatch for the DiT.

Port of `flexam_tpu/core/attention.py`. On a CUDA tensor it launches kernel
B1 (`ops.flash_attention.flash_attention`), or B2 (`single_kv_attention`)
when every key fits one block (at most 512 keys: the DiT's cross-attention
over the text tokens). On a CPU tensor it takes the plain version. There is
no fallback on CUDA: an input the kernels do not take raises.

The `FLEXAM_ATTENTION` backend ladder of the JAX package (sparse, int8) is
not ported yet: a value other than the dense defaults raises.

Inputs use layout [B, L, H, D]; `k_len` masks padded keys.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from flexam_tpu_torch.ops.flash_attention import (SINGLE_KV_MAX_KEYS,
                                                  attention_plain,
                                                  flash_attention,
                                                  single_kv_attention)

# FLEXAM_ATTENTION values that name the dense exact path this port has
DENSE_BACKENDS = ("", "pallas", "flash", "flash_attn_2", "flash_attn_3")


def _check_backend() -> None:
    env = (os.environ.get("FLEXAM_ATTENTION")
           or os.environ.get("VIDEOX_ATTENTION_TYPE", "")).lower()
    if env not in DENSE_BACKENDS:
        raise NotImplementedError(
            f"FLEXAM_ATTENTION={env!r} is not ported to flexam_tpu_torch yet "
            "(only the dense exact kernels B1/B2 are)")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              k_len: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Exact softmax attention over [B, L, H, D] tensors."""
    _check_backend()
    if not q.is_cuda:
        return attention_plain(q, k, v, k_len=k_len, scale=scale)
    if k.shape[1] <= SINGLE_KV_MAX_KEYS:
        return single_kv_attention(q, k, v, k_len=k_len, scale=scale)
    return flash_attention(q, k, v, k_len=k_len, scale=scale)
