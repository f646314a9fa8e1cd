"""Attention dispatch for the DiT: the backend ladder.

Port of `flexam_tpu/core/attention.py`. The backends keep the JAX
package's names, so that `FLEXAM_ATTENTION` means the same in both:

  pallas       the exact kernels: B1 (`ops.flash_attention`), or B2 when
               every key fits one block (at most 512 keys: the DiT's
               cross-attention over the text tokens);
  pallas_int8  B6 (`ops.int8_attention`), int8 Q K^T; chosen explicitly
               (`pallas_int8`, `sage`, `sageattn`) it takes EVERY call,
               cross-attention included; the auto default takes it only for
               self-attention (lq == lk) of at least INT8_AUTO_MIN_TOKENS
               tokens, unless FLEXAM_INT8_AUTO=0;
  xla          the compiler's fused attention (`xla`, `torch_sdpa`). The
               port has no such thing: on a CPU tensor it is the plain
               exact version, on a CUDA tensor it raises;
  sparse       (`sparse`, `pallas_sparse`) B5 for video self-attention,
               resolved by the pipeline, which knows the latent geometry;
               generic calls take the auto default.

`flash`, `flash_attn_2` and `flash_attn_3` name pallas; any other value
takes the auto default, which is pallas here on both devices (the JAX
package picks xla off the TPU). On a CPU tensor each kernel takes its plain
version; on CUDA there is no fallback: an input the kernel does not take
raises.

Head dims the kernels do not take (not a multiple of 128: the tiny test
config's 24, the SVD UNet's 64) go to `exact_attention`, the counterpart of
JAX's `xla_attention`, for the pallas and pallas_int8 backends alike: where
JAX's dispatcher catches its kernels' NotImplementedError, this one decides
by shape before any launch, on both devices. `exact_calls` counts the
branch's calls beside the kernels' launch counters.

Inputs use layout [B, L, H, D]; `k_len` masks padded keys.
"""

from __future__ import annotations

import functools
import os
import sys
from typing import Optional

import torch

from flexam_tpu_torch.ops.flash_attention import (SINGLE_KV_MAX_KEYS,
                                                  attention_plain,
                                                  flash_attention,
                                                  single_kv_attention)
from flexam_tpu_torch.ops.int8_attention import int8_attention

# Self-attention of at least this many tokens takes B6 under the auto
# default: the JAX package's threshold (a 201-frame clip at 512x896, 52 x
# 448 tokens), kept so that both packages compute the same function.
INT8_AUTO_MIN_TOKENS = 23296

# calls of the exact branch (head dims the kernels do not take)
exact_calls = {"exact_attention": 0}


def exact_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    k_len: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v over [B, L, H, D]: JAX's `xla_attention`,
    work XLA emits there, so here the plain version in torch ops
    (`attention_plain`), counted in `exact_calls`."""
    exact_calls["exact_attention"] += 1
    return attention_plain(q, k, v, k_len=k_len, scale=scale)


@functools.lru_cache(maxsize=1)
def _backend_choice() -> tuple:
    """(backend, explicit): `explicit` marks a user-forced selection —
    the long-sequence int8 auto-upgrade only applies to the auto default."""
    env = (os.environ.get("FLEXAM_ATTENTION")
           or os.environ.get("VIDEOX_ATTENTION_TYPE", "")).lower()
    if env in ("pallas", "xla", "pallas_int8"):
        return env, True
    if env in ("flash_attn_3", "flash_attn_2", "flash"):
        return "pallas", True
    if env in ("sage", "sageattn"):
        return "pallas_int8", True
    if env == "torch_sdpa":
        return "xla", True
    return "pallas", False


def _default_backend() -> str:
    return _backend_choice()[0]


# callers re-resolve after changing FLEXAM_ATTENTION
_default_backend.cache_clear = _backend_choice.cache_clear

_INT8_AUTO_ANNOUNCED = False


def resolve_backend(lq: int, lk: int, backend: Optional[str] = None) -> str:
    """Final backend for one call: an explicit argument or env choice wins;
    the auto default upgrades to int8 for self-attention of at least
    INT8_AUTO_MIN_TOKENS tokens, announced once per process on stderr."""
    if backend is not None:
        return backend
    backend, explicit = _backend_choice()
    if (not explicit and backend == "pallas" and lq == lk
            and lq >= INT8_AUTO_MIN_TOKENS
            and os.environ.get("FLEXAM_INT8_AUTO", "1") != "0"):
        global _INT8_AUTO_ANNOUNCED
        if not _INT8_AUTO_ANNOUNCED:
            _INT8_AUTO_ANNOUNCED = True
            print(f"[flexam] long-sequence self-attention ({lq} tokens >= "
                  f"{INT8_AUTO_MIN_TOKENS}): auto-upgrading to the int8 "
                  "attention kernel (~1e-2 rel err; FLEXAM_INT8_AUTO=0 "
                  "keeps the exact bf16 kernel)", file=sys.stderr, flush=True)
        return "pallas_int8"
    return backend


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              k_len: Optional[torch.Tensor] = None,
              scale: Optional[float] = None,
              backend: Optional[str] = None) -> torch.Tensor:
    """Dispatching attention over [B, L, H, D] tensors."""
    backend = resolve_backend(q.shape[1], k.shape[1], backend)
    if backend == "xla":
        if q.is_cuda:
            raise NotImplementedError(
                "attention backend 'xla' (FLEXAM_ATTENTION=xla/torch_sdpa) "
                "names the compiler's fused attention, which the port does "
                "not have: on CUDA it runs its own kernels (pallas, "
                "pallas_int8, sparse)")
        return attention_plain(q, k, v, k_len=k_len, scale=scale)
    # the kernels take head dims that are a multiple of 128; the JAX
    # package sends the others to exact attention
    if q.shape[-1] % 128 != 0:
        return exact_attention(q, k, v, k_len=k_len, scale=scale)
    if backend == "pallas_int8":
        return int8_attention(q, k, v, k_len=k_len, scale=scale)
    if not q.is_cuda:
        return attention_plain(q, k, v, k_len=k_len, scale=scale)
    if k.shape[1] <= SINGLE_KV_MAX_KEYS:
        return single_kv_attention(q, k, v, k_len=k_len, scale=scale)
    return flash_attention(q, k, v, k_len=k_len, scale=scale)
