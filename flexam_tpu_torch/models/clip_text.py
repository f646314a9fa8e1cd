"""CLIP text encoder (ViT-L/14 text tower).

Port of `flexam_tpu/models/clip_text.py`. FLUX conditions on the pooled
output of the openai CLIP-L text model: token + position embeddings,
pre-LN causal blocks with quick-GELU MLPs, a final layer norm, pooling at
the first EOS token (the transformers `CLIPTextModel` semantics). The
causal mask is a bias of float32's lowest value added to the fp32 logits,
as in JAX; the blocks are one dict each in `blocks`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch

from flexam_tpu_torch.core.layers import ParamDraw, linear
from flexam_tpu_torch.device import resolve_device
from flexam_tpu_torch.models.clip import _layer_norm


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab: int = 49408
    dim: int = 768
    num_heads: int = 12
    num_layers: int = 12
    mlp_ratio: float = 4.0
    max_positions: int = 77
    eos_id: int = 49407
    eps: float = 1e-5

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        return cls(vocab=64, dim=32, num_heads=2, num_layers=2,
                   max_positions=10, eos_id=63)


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def clip_text_forward(params: dict, cfg: CLIPTextConfig, ids: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids [B, L] int -> (last_hidden [B, L, D], pooled [B, D]); pooled is
    the hidden state at the first EOS token (the last position when a row
    has none)."""
    b, l = ids.shape
    ids = ids.long().to(params["token_embedding"].device)
    x = (params["token_embedding"][ids]
         + params["pos_embedding"][:l][None]).to(
        params["token_embedding"].dtype)
    pos = torch.arange(l, device=x.device)
    causal = torch.where(pos[None, :] <= pos[:, None], 0.0,
                         torch.finfo(torch.float32).min)
    n, d = cfg.num_heads, cfg.dim // cfg.num_heads
    for bp in params["blocks"]:
        hn = _layer_norm(x, bp["norm1_w"], bp["norm1_b"], cfg.eps)
        q = linear(hn, bp["q"]).reshape(b, l, n, d) * (d ** -0.5)
        k = linear(hn, bp["k"]).reshape(b, l, n, d)
        v = linear(hn, bp["v"]).reshape(b, l, n, d)
        logits = torch.einsum("binc,bjnc->bnij", q.float(), k.float())
        probs = torch.softmax(logits + causal, dim=-1).to(x.dtype)
        o = torch.einsum("bnij,bjnc->binc", probs, v).reshape(b, l, -1)
        x = x + linear(o, bp["o"])
        hn = _layer_norm(x, bp["norm2_w"], bp["norm2_b"], cfg.eps)
        x = x + linear(_quick_gelu(linear(hn, bp["fc1"])), bp["fc2"])
    x = _layer_norm(x, params["norm_w"], params["norm_b"], cfg.eps)
    is_eos = ids == cfg.eos_id
    eos_pos = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1),
                          l - 1)
    return x, x[torch.arange(b, device=x.device), eos_pos]


def init_clip_text_params(cfg: CLIPTextConfig, seed: int = 0,
                          dtype=torch.float32, device="cuda") -> dict:
    """Random parameters with the JAX init's distributions (xavier-uniform
    linears, normal embeddings), drawn on the device."""
    dev = resolve_device(device)
    draw = ParamDraw(seed, dtype, dev)
    d, mid = cfg.dim, int(cfg.dim * cfg.mlp_ratio)

    def lin(i, o):
        limit = math.sqrt(6.0 / (i + o))
        w = torch.empty((o, i), device=dev).uniform_(-limit, limit,
                                                      generator=draw.gen)
        return {"weight": w.to(dtype), "bias": draw.full((o,), 0.0)}

    def block():
        return {"norm1_w": draw.full((d,), 1.0),
                "norm1_b": draw.full((d,), 0.0),
                "q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
                "o": lin(d, d),
                "norm2_w": draw.full((d,), 1.0),
                "norm2_b": draw.full((d,), 0.0),
                "fc1": lin(d, mid), "fc2": lin(mid, d)}

    return {"token_embedding": draw.normal((cfg.vocab, d), 0.02),
            "pos_embedding": draw.normal((cfg.max_positions, d), 0.01),
            "blocks": [block() for _ in range(cfg.num_layers)],
            "norm_w": draw.full((d,), 1.0), "norm_b": draw.full((d,), 0.0)}


def _hf_names(cfg: CLIPTextConfig) -> Dict[str, tuple]:
    """transformers `CLIPTextModel` key (without `text_model.`) -> path."""
    names = {"embeddings.token_embedding.weight": ("token_embedding",),
             "embeddings.position_embedding.weight": ("pos_embedding",),
             "final_layer_norm.weight": ("norm_w",),
             "final_layer_norm.bias": ("norm_b",)}
    for i in range(cfg.num_layers):
        p = f"encoder.layers.{i}"
        for n in ("1", "2"):
            names[f"{p}.layer_norm{n}.weight"] = ("blocks", i, f"norm{n}_w")
            names[f"{p}.layer_norm{n}.bias"] = ("blocks", i, f"norm{n}_b")
        for ours, hf in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                         ("v", "self_attn.v_proj"),
                         ("o", "self_attn.out_proj"), ("fc1", "mlp.fc1"),
                         ("fc2", "mlp.fc2")):
            for wb in ("weight", "bias"):
                names[f"{p}.{hf}.{wb}"] = ("blocks", i, ours, wb)
    return names


def clip_text_params_from_state_dict(sd: Mapping, cfg: CLIPTextConfig,
                                     dtype=torch.float32,
                                     device="cuda") -> dict:
    """Map a transformers `CLIPTextModel` state dict (with or without the
    `text_model.` prefix) onto the port's tree, on `device` in `dtype`;
    a missing key raises KeyError, as in JAX."""
    from flexam_tpu_torch.io.checkpoints import _source
    from flexam_tpu_torch.io.convert import leaf
    dev = resolve_device(device)
    params: dict = {"blocks": [{} for _ in range(cfg.num_layers)]}
    for key, path in _hf_names(cfg).items():
        k = key if key in sd else f"text_model.{key}"
        if k not in sd:
            raise KeyError(key)
        node = params
        for p in path[:-1]:
            node = node[p] if isinstance(p, int) else node.setdefault(p, {})
        node[path[-1]] = leaf(_source(sd, k)[0], dev, dtype)
    return params


def clip_text_state_dict(params: dict, cfg: CLIPTextConfig
                         ) -> Dict[str, torch.Tensor]:
    """The inverse map: transformers `CLIPTextModel` names (prefixed
    `text_model.`), tensors as stored."""
    out = {}
    for key, path in _hf_names(cfg).items():
        node = params
        for p in path:
            node = node[p]
        out[f"text_model.{key}"] = node
    return out
