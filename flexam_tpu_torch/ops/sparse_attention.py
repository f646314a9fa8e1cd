"""Block-sparse video self-attention: kernel B5, its plain version and the
sparsity policy.

Port of `flexam_tpu/ops/sparse_attention.py`. The DiT's token stream is
frame-major: `lt` frames of `(lh/2)*(lw/2)` spatial tokens, then one ref
block of the same size. One frame (or `group` merged frames) is one
attention block. Frame i attends to frames [i - window, i + window], frame
0 (the sink) and the ref block; the ref block attends to everything. The
policy functions are copies of the JAX package's, so both packages run the
same mask.

The CUDA kernel lives in `csrc/sparse_attention.cu`. It takes the
compacted per-row key-block lists `kidx [nq, max_nnz]` and `nnz [nq]` as
int32 tensors on the device and a scratch int32 for the counter by which
its CTAs take their work items (the entry point zeroes it), and runs B1's
online softmax over each query block's active key blocks only, at any head
dim that is a multiple of 128 (`flash_attention.attention_instance`), in
bf16 or fp32 (TF32 wgmma, after B1's pre-pass: q and k rounded to tf32 and
V^T written rounded, into workspaces allocated here); fp16 raises
TypeError.
`masked_dense_attention` is its plain version: dense attention under the token mask the rows expand to, with the
probabilities cast to q's dtype before P.V as in B1's plain version.

Opt in with `FLEXAM_ATTENTION=sparse` (and `FLEXAM_SPARSE_WINDOW=w`), which
the pipeline resolves per latent geometry, or pass `make_sparse_attn_fn(...)`
as the pipeline's `attn_fn`. A call that is not the video self-attention of
that geometry (cross-attention, a `k_len` mask, a geometry the policy cannot
tile) goes to the dense dispatch of `core.attention`, whose kernels count
their own launches.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexam_tpu_torch.ops import build
from flexam_tpu_torch.ops.flash_attention import (DTYPES, LOG2E,
                                                  attention_plain,
                                                  check_inputs, vt_workspace)

# kernel launches on CUDA tensors
launches = {"sparse_attention": 0}


# --------------------------------------------------------------------------
# sparsity policy (copies of the JAX package's functions)
# --------------------------------------------------------------------------

def video_block_rows(
    num_frames: int,
    window: int = 2,
    ref_block: bool = True,
    anchor_first: bool = True,
) -> List[List[int]]:
    """Active key-block indices per query block.

    Blocks 0..num_frames-1 are frames; block num_frames (if `ref_block`)
    is the reference-image token block. Frame i attends to frames
    [i-window, i+window], frame 0 (sink) and the ref block; the ref block
    attends to everything.
    """
    n = num_frames + (1 if ref_block else 0)
    rows: List[List[int]] = []
    for i in range(num_frames):
        row = set(range(max(0, i - window), min(num_frames, i + window + 1)))
        if anchor_first:
            row.add(0)
        if ref_block:
            row.add(num_frames)
        rows.append(sorted(row))
    if ref_block:
        rows.append(list(range(n)))
    return rows


def coarsen_rows(rows: Sequence[Sequence[int]], group: int
                 ) -> List[List[int]]:
    """Merge `group` consecutive fine blocks into one coarse block; a
    coarse pair (I, J) is active iff ANY member fine pair is active."""
    n = len(rows)
    assert n % group == 0, (n, group)
    coarse = []
    for i0 in range(0, n, group):
        acc = set()
        for i in range(i0, i0 + group):
            acc.update(j // group for j in rows[i])
        coarse.append(sorted(acc))
    return coarse


def rows_to_arrays(rows: Sequence[Sequence[int]]) -> Tuple[np.ndarray,
                                                           np.ndarray]:
    """Compact ragged rows into (kidx [nq, max_nnz], nnz [nq]) int32,
    padding each row with its last active index (clamp target)."""
    nnz = np.asarray([len(r) for r in rows], np.int32)
    m = int(nnz.max())
    kidx = np.stack([np.pad(np.asarray(r, np.int32), (0, m - len(r)),
                            mode="edge") for r in rows])
    return kidx, nnz


def rows_to_block_mask(rows: Sequence[Sequence[int]]) -> np.ndarray:
    """Dense [nb, nb] bool block mask from per-row active key lists: the
    form `parallel.ring.ring_accumulate` takes for the block-sparse ring
    hops of USP."""
    nb = len(rows)
    mask = np.zeros((nb, nb), bool)
    for i, r in enumerate(rows):
        mask[i, list(r)] = True
    return mask


def pick_group(n_blocks: int, spatial_tokens: int,
               max_blk: int = 1456, max_group: int = 2) -> int:
    """Largest divisor of n_blocks with merged blocks of at most `max_blk`
    tokens and at most `max_group` frames (a group larger than the temporal
    window would wash the sparsity out)."""
    best = 1
    for g in range(1, n_blocks + 1):
        if (n_blocks % g == 0 and g * spatial_tokens <= max_blk
                and g <= max_group):
            best = g
    return best


def video_sparse_policy(
    num_frames: int,
    spatial_tokens: int,
    ref_tokens: int = 0,
    window: int = 2,
    group: Optional[int] = None,
) -> dict:
    """Resolve the video sparsity policy once: {"rows", "blk",
    "video_len"}."""
    if ref_tokens not in (0, spatial_tokens):
        raise ValueError("ref_tokens must be 0 or == spatial_tokens")
    rows = video_block_rows(num_frames, window=window,
                            ref_block=ref_tokens > 0)
    if group is None:
        group = pick_group(len(rows), spatial_tokens,
                           max_group=max(1, window))
    blk = spatial_tokens * group
    if group > 1:
        rows = coarsen_rows(rows, group)
    return {"rows": rows, "blk": blk,
            "video_len": num_frames * spatial_tokens + ref_tokens}


# --------------------------------------------------------------------------
# kernel and plain version
# --------------------------------------------------------------------------

def _check_geometry(q, k, rows, blk):
    if q.shape[1] != len(rows) * blk or k.shape[1] != q.shape[1]:
        raise ValueError(f"geometry mismatch: L={q.shape[1]}, Lk="
                         f"{k.shape[1]}, rows={len(rows)}, blk={blk}")


def masked_dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rows: Sequence[Sequence[int]], blk: int,
                           scale: Optional[float] = None,
                           q_chunk: int = 512) -> torch.Tensor:
    """Dense attention under the token mask `rows` expands to: B5's
    function with none of its constraints, over query chunks of `q_chunk`
    rows (the full L x L mask never exists)."""
    _check_geometry(q, k, rows, blk)
    mask = torch.from_numpy(rows_to_block_mask(rows)).to(q.device)
    tok_blk = torch.arange(q.shape[1], device=q.device) // blk

    def keep_rows(a, b):
        return mask[tok_blk[a:b]][:, tok_blk]

    return attention_plain(q, k, v, scale=scale, q_chunk=q_chunk,
                           keep_rows=keep_rows)


def sparse_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rows: Sequence[Sequence[int]], blk: int,
                           scale: Optional[float] = None,
                           kidx: Optional[torch.Tensor] = None,
                           nnz: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """B5: block-sparse attention over [B, L, H, D], bf16 or fp32, with
    L = len(rows) * blk; `rows[i]` lists the key blocks query block i
    sees. `kidx`/`nnz`
    are `rows_to_arrays(rows)` as int32 on q's device (made here if not
    given)."""
    if not q.is_cuda:
        return masked_dense_attention(q, k, v, rows, blk, scale=scale)
    build.refuse_autograd("sparse_attention", q, k, v)
    _check_geometry(q, k, rows, blk)
    check_inputs(q, k, v, None, "sparse_attention", DTYPES)
    if min(len(r) for r in rows) < 1:
        raise ValueError("sparse_attention: every query block needs at least "
                         "one key block")
    if kidx is None or nnz is None:
        kidx, nnz = (torch.from_numpy(a).to(q.device)
                     for a in rows_to_arrays(rows))
    if (kidx.device != q.device or nnz.device != q.device
            or kidx.dtype != torch.int32 or nnz.dtype != torch.int32
            or nnz.shape != (len(rows),) or kidx.dim() != 2
            or kidx.shape[0] != len(rows) or not kidx.is_contiguous()):
        raise ValueError("sparse_attention: kidx [nq, max_nnz] and nnz [nq] "
                         "must be contiguous int32 on q's device")
    b, _, h, d = q.shape
    counter = torch.empty(1, dtype=torch.int32, device=q.device)
    out = torch.empty_like(q)
    tail = (kidx.data_ptr(), nnz.data_ptr(), counter.data_ptr(), b, h,
            len(rows), blk, kidx.shape[1], d,
            float((d ** -0.5 if scale is None else scale) * LOG2E),
            build.stream_handle(q))
    if q.dtype == torch.float32:
        # the pre-pass's outputs, as B1's: q and k rounded to tf32, V^T
        # rounded
        qw, kw, vt = torch.empty_like(q), torch.empty_like(k), vt_workspace(v)
        err = build.library().flexam_sparse_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qw.data_ptr(),
            kw.data_ptr(), vt.data_ptr(), out.data_ptr(), *tail)
    else:
        err = build.library().flexam_sparse_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *tail)
    build.check(err, "sparse_attention")
    launches["sparse_attention"] += 1
    return out


# --------------------------------------------------------------------------
# DiT integration
# --------------------------------------------------------------------------

def make_sparse_attn_fn(
    num_frames: int,
    spatial_tokens: int,
    ref_tokens: int = 0,
    window: int = 2,
    group: Optional[int] = None,
):
    """An `attn_fn` for `dit_forward(..., attn_fn=...)` that runs video
    self-attention block-sparse and everything else dense.

    A call is video self-attention iff Lq == Lk == num_frames *
    spatial_tokens + ref_tokens and it has no `k_len`; it takes B5 when the
    blocks are a multiple of 8 tokens and head_dim a multiple of 128 (the
    JAX dispatch), else the dense dispatch. On a CPU tensor B5 takes its
    plain version, `masked_dense_attention`.
    """
    from flexam_tpu_torch.core.attention import attention as dense_attention

    policy = video_sparse_policy(num_frames, spatial_tokens,
                                 ref_tokens=ref_tokens, window=window,
                                 group=group)
    rows, blk, video_len = (policy["rows"], policy["blk"],
                            policy["video_len"])
    arrays = rows_to_arrays(rows)
    on_device = {}      # device -> (kidx, nnz), made at first use

    def attn_fn(q, k, v, k_len=None, scale=None):
        if q.shape[1] == k.shape[1] == video_len and k_len is None:
            if blk % 8 == 0 and q.shape[-1] % 128 == 0:
                if q.device not in on_device:
                    on_device[q.device] = tuple(
                        torch.from_numpy(a).to(q.device) for a in arrays)
                kidx, nnz = on_device[q.device]
                return sparse_flash_attention(q, k, v, rows, blk,
                                              scale=scale, kidx=kidx,
                                              nnz=nnz)
        return dense_attention(q, k, v, k_len=k_len, scale=scale)

    return attn_fn


def sparse_attn_fn_for_latent(latent_shape: Tuple[int, int, int],
                              patch: Tuple[int, int, int] = (1, 2, 2),
                              has_ref: bool = True,
                              window: Optional[int] = None):
    """Latent (F, H, W) -> sparse attn_fn. `window` defaults from
    FLEXAM_SPARSE_WINDOW (2)."""
    f, h, w = latent_shape
    spatial = (h // patch[1]) * (w // patch[2])
    if window is None:
        window = int(os.environ.get("FLEXAM_SPARSE_WINDOW", "2"))
    return make_sparse_attn_fn(f // patch[0], spatial,
                               ref_tokens=spatial if has_ref else 0,
                               window=window)
