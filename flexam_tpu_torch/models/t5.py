"""umT5-XXL text encoder in PyTorch.

Port of `flexam_tpu/models/t5.py`: per-layer bidirectional relative-position
buckets (a static numpy table), UNSCALED attention (T5 convention) with the
position bias and the padding mask added to the logits, a gated GELU-tanh
FFN, and RMS-style T5 LayerNorm with fp32 statistics. It runs no kernel of
its own: the matmuls and the softmax are PyTorch ops.

Parameters are the JAX tree with `blocks` as a list of per-block dicts. The
encoder computes in fp32 unless the tree holds a "compute_dtype" entry, as
the JAX version does.

Under `parallel.activation_sharding(mesh)` with a tree split by
`parallel.t5_param_shardings` (tp over the heads and the ffn, the token
embedding over vocabulary rows), each tp rank runs its heads and ffn
columns and sums the output projections over tp; the embedding looks up
the ids in its rows (zeros for the others) and sums over tp. Every rank
returns the whole hidden states.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from flexam_tpu_torch.config import T5Config
from flexam_tpu_torch.core.layers import gelu_tanh
from flexam_tpu_torch.device import resolve_device
from flexam_tpu_torch.parallel import comm


def t5_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * w, fp32 statistics."""
    xf = x.float()
    inv = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * weight.to(x.dtype)


def relative_position_buckets(lq: int, lk: int, num_buckets: int,
                              max_dist: int = 128,
                              bidirectional: bool = True) -> np.ndarray:
    """Static bucket table [Lq, Lk] (T5 relative-position bucketing)."""
    rel_pos = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    if bidirectional:
        nb = num_buckets // 2
        buckets = (rel_pos > 0).astype(np.int64) * nb
        rel_pos = np.abs(rel_pos)
    else:
        nb = num_buckets
        buckets = np.zeros_like(rel_pos)
        rel_pos = -np.minimum(rel_pos, 0)
    max_exact = nb // 2
    with np.errstate(divide="ignore"):
        large = max_exact + (
            np.log(np.maximum(rel_pos, 1).astype(np.float64) / max_exact)
            / math.log(max_dist / max_exact) * (nb - max_exact)
        ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets = buckets + np.where(rel_pos < max_exact, rel_pos, large)
    return buckets.astype(np.int32)


def _pos_bias(embedding: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """embedding [num_buckets, H] -> fp32 bias [1, H, Lq, Lk]."""
    return embedding.float()[buckets].permute(2, 0, 1)[None]


def _t5_attention(p: dict, x: torch.Tensor, mask: Optional[torch.Tensor],
                  pos_bias: torch.Tensor, num_heads: int,
                  tp=None) -> torch.Tensor:
    """num_heads: the heads this rank holds (all of them off tp)."""
    b, l, _ = x.shape
    x = comm.copy_to(x, tp, "tp")
    d = p["q"].shape[0] // num_heads
    q = torch.matmul(x, p["q"].to(x.dtype).t()).reshape(b, l, num_heads, d)
    k = torch.matmul(x, p["k"].to(x.dtype).t()).reshape(b, l, num_heads, d)
    v = torch.matmul(x, p["v"].to(x.dtype).t()).reshape(b, l, num_heads, d)
    logits = torch.einsum("binc,bjnc->bnij", q.float(), k.float())
    logits = logits + pos_bias
    if mask is not None:
        neg = torch.finfo(torch.float32).min
        logits = logits.masked_fill(mask[:, None, None, :] == 0, neg)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bnij,bjnc->binc", probs.float(), v.float()).to(x.dtype)
    out = torch.matmul(out.reshape(b, l, -1), p["o"].to(x.dtype).t())
    return comm.reduce_from(out, tp, "tp")


def _t5_ffn(p: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    x = comm.copy_to(x, tp, "tp")
    gate = gelu_tanh(torch.matmul(x, p["gate"].to(x.dtype).t()))
    h = torch.matmul(x, p["fc1"].to(x.dtype).t()) * gate
    return comm.reduce_from(torch.matmul(h, p["fc2"].to(x.dtype).t()),
                            tp, "tp")


def _embed(table: torch.Tensor, ids: torch.Tensor, cfg: T5Config, tp):
    """Token embedding; under tp `table` holds this rank's vocabulary rows:
    the ids outside them look up zeros, and the ranks' rows are summed."""
    if tp is None or table.shape[0] == cfg.vocab:
        return table[ids]
    first = tp.index("tp") * table.shape[0]
    local = ids - first
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(inside, local, torch.zeros_like(local))]
    return comm.reduce_from(rows * inside[..., None].to(rows.dtype), tp, "tp")


def t5_encode(params: dict, cfg: T5Config, input_ids: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """input_ids [B, L] int; attention_mask [B, L] (1 token, 0 pad).
    Returns the last hidden states [B, L, dim]."""
    from flexam_tpu_torch.parallel.sharding import active_mesh
    l = input_ids.shape[1]
    dtype = params.get("compute_dtype", torch.float32)
    mesh = active_mesh()
    tp = mesh if mesh is not None and mesh.shape.get("tp", 1) > 1 else None
    x = _embed(params["token_embedding"], input_ids.long(), cfg, tp).to(dtype)
    heads, h0 = cfg.num_heads, 0
    if tp is not None and params["blocks"] and (
            params["blocks"][0]["attn"]["q"].shape[0] < cfg.dim_attn):
        heads = cfg.num_heads // tp.shape["tp"]
        h0 = tp.index("tp") * heads
    buckets = torch.from_numpy(relative_position_buckets(
        l, l, cfg.num_buckets, max_dist=cfg.max_distance)).long().to(x.device)

    def bias_of(table):
        return _pos_bias(table, buckets)[:, h0:h0 + heads]

    shared = (bias_of(params["shared_pos_embedding"])
              if cfg.shared_pos else None)
    tp_blocks = tp if heads != cfg.num_heads else None
    for bp in params["blocks"]:
        bias = shared if shared is not None else bias_of(bp["pos_embedding"])
        x = x + _t5_attention(bp["attn"], t5_layer_norm(x, bp["norm1"]),
                              attention_mask, bias, heads, tp_blocks)
        x = x + _t5_ffn(bp["ffn"], t5_layer_norm(x, bp["norm2"]), tp_blocks)
    return t5_layer_norm(x, params["norm"])


def init_t5_params(cfg: T5Config, seed: int = 0, dtype=torch.bfloat16,
                   device="cuda") -> dict:
    """Random parameters with the JAX init's distributions, drawn on the
    device from a `torch.Generator` seeded with `seed`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, da, df, h = cfg.dim, cfg.dim_attn, cfg.dim_ffn, cfg.num_heads

    def n(shape, std):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype) * std

    def ones(c):
        return torch.ones((c,), dtype=dtype, device=dev)

    blocks = []
    for _ in range(cfg.num_layers):
        bp = {
            "norm1": ones(d),
            "attn": {"q": n((da, d), (d * da) ** -0.5),
                     "k": n((da, d), d ** -0.5),
                     "v": n((da, d), d ** -0.5),
                     "o": n((d, da), (h * da) ** -0.5)},
            "norm2": ones(d),
            "ffn": {"gate": n((df, d), d ** -0.5),
                    "fc1": n((df, d), d ** -0.5),
                    "fc2": n((d, df), df ** -0.5)},
        }
        if not cfg.shared_pos:
            bp["pos_embedding"] = n((cfg.num_buckets, h),
                                    (2 * cfg.num_buckets * h) ** -0.5)
        blocks.append(bp)
    params = {"token_embedding": n((cfg.vocab, d), 1.0), "blocks": blocks,
              "norm": ones(d)}
    if cfg.shared_pos:
        params["shared_pos_embedding"] = n((cfg.num_buckets, h),
                                           (2 * cfg.num_buckets * h) ** -0.5)
    return params


def t5_params_from_state_dict(sd, cfg: T5Config, dtype=torch.float32,
                              device="cuda") -> dict:
    """Map a `WanT5EncoderModel` state dict to the port's per-layer tree on
    `device`, every leaf cast to `dtype` (JAX's loader gives float32)."""
    from flexam_tpu_torch.io.checkpoints import _source
    from flexam_tpu_torch.io.convert import leaf

    dev = resolve_device(device)

    def g(key):
        return leaf(_source(sd, key)[0], dev, dtype)

    blocks = []
    for i in range(cfg.num_layers):
        p = f"blocks.{i}"
        blocks.append({
            "norm1": g(f"{p}.norm1.weight"),
            "attn": {"q": g(f"{p}.attn.q.weight"),
                     "k": g(f"{p}.attn.k.weight"),
                     "v": g(f"{p}.attn.v.weight"),
                     "o": g(f"{p}.attn.o.weight")},
            "norm2": g(f"{p}.norm2.weight"),
            "ffn": {"gate": g(f"{p}.ffn.gate.0.weight"),
                    "fc1": g(f"{p}.ffn.fc1.weight"),
                    "fc2": g(f"{p}.ffn.fc2.weight")},
            "pos_embedding": g(f"{p}.pos_embedding.embedding.weight"),
        })
    return {"token_embedding": g("token_embedding.weight"), "blocks": blocks,
            "norm": g("norm.weight")}


def t5_params_from_hf_state_dict(sd, cfg: T5Config, dtype=torch.float32,
                                 device="cuda") -> dict:
    """Map a HuggingFace `T5EncoderModel` state dict (`encoder.block.N.
    layer.0.SelfAttention.q.weight`, gated `DenseGatedActDense`; keys with
    or without the `encoder.` prefix) to the port's per-layer tree. The
    relative-attention bias of block 0 becomes `shared_pos_embedding` when
    cfg.shared_pos (T5 v1.1 keeps one table)."""
    from flexam_tpu_torch.io.checkpoints import _source
    from flexam_tpu_torch.io.convert import leaf

    dev = resolve_device(device)

    def g(key):
        k = key if key in sd else f"encoder.{key}"
        return leaf(_source(sd, k)[0], dev, dtype)

    blocks = []
    for i in range(cfg.num_layers):
        p = f"block.{i}.layer"
        blocks.append({
            "norm1": g(f"{p}.0.layer_norm.weight"),
            "attn": {"q": g(f"{p}.0.SelfAttention.q.weight"),
                     "k": g(f"{p}.0.SelfAttention.k.weight"),
                     "v": g(f"{p}.0.SelfAttention.v.weight"),
                     "o": g(f"{p}.0.SelfAttention.o.weight")},
            "norm2": g(f"{p}.1.layer_norm.weight"),
            "ffn": {"gate": g(f"{p}.1.DenseReluDense.wi_0.weight"),
                    "fc1": g(f"{p}.1.DenseReluDense.wi_1.weight"),
                    "fc2": g(f"{p}.1.DenseReluDense.wo.weight")},
        })
    params = {
        "token_embedding": (g("shared.weight") if "shared.weight" in sd
                            else g("embed_tokens.weight")),
        "blocks": blocks,
        "norm": g("final_layer_norm.weight"),
    }
    if cfg.shared_pos:
        params["shared_pos_embedding"] = g(
            "block.0.layer.0.SelfAttention.relative_attention_bias.weight")
    return params
