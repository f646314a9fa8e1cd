"""CLIP vision tower (open-clip ViT-H/14), the image-embedding half of
`flexam_tpu/models/clip.py`.

`vit_forward` is the reference `VisionTransformer.forward`
(`wan_image_encoder.py:281-303`); `clip_encode_video_frames` its
`CLIPModel.forward` (penultimate-block tokens of 224 bicubic frames);
`clip_image_embed` the HF ``CLIPVisionModelWithProjection.image_embeds``
head DepthCrafter conditions on (CLS, post-LN, bias-free projection);
`clip_vision_params_from_hf` / `vit_params_from_state_dict` map the HF and
reference files. `_layer_norm` (fp32 statistics and affine, one cast at
the end) is shared with `models/clip_text.py`.

The attention calls JAX's `xla_attention` directly, which is
`core.attention.exact_attention` here (ViT-H's heads are 80 wide). The 224
resize is `jax.image.resize(..., "bicubic")` (antialiased Keys cubic):
`core.resize.resize`. Blocks are one dict each in `blocks` (JAX stacks
them; `io/convert.py` crosses).

The XLM-RoBERTa text half (`xlm_roberta_forward`, reference
`wan_xlm_roberta.py` `XLMRoberta`, :76-130) has no caller in either
package (the Wan2.1 i2v configs list it). Its 64-wide heads take the exact
branch with JAX's `k_len` key mask, here -1e30 where JAX puts -inf: every
id row holds a token that is not padding, so no row is fully masked and
the two agree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from flexam_tpu_torch.core.attention import exact_attention
from flexam_tpu_torch.core.layers import (ParamDraw, gelu_tanh, linear,
                                          linear_init)
from flexam_tpu_torch.device import resolve_device

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class CLIPVisionConfig:
    """ViT-H/14 geometry (`clip_xlm_roberta_vit_h_14`)."""
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: int = 4
    num_heads: int = 16
    num_layers: int = 32
    activation: str = "gelu"     # 'gelu' | 'quick_gelu'
    pre_norm: bool = True
    norm_eps: float = 1e-5


@dataclass(frozen=True)
class XLMRobertaConfig:
    vocab_size: int = 250002
    max_seq_len: int = 514
    pad_id: int = 1
    dim: int = 1024
    num_heads: int = 16
    num_layers: int = 24
    post_norm: bool = True
    eps: float = 1e-5


def _layer_norm(x, w, b, eps):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).pow(2).mean(-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def _act(x, kind):
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return gelu_tanh(x) if kind == "gelu_tanh" else F.gelu(x)


def _vit_block(bp, x, cfg: CLIPVisionConfig):
    """Pre-norm CLIP block (`wan_image_encoder.py:148-155`)."""
    h = _layer_norm(x, bp["norm1_w"], bp["norm1_b"], cfg.norm_eps)
    b, s, c = h.shape
    n = cfg.num_heads
    q, k, v = linear(h, bp["to_qkv"]).reshape(b, s, 3, n, c // n).unbind(2)
    o = exact_attention(q, k, v).reshape(b, s, c)
    x = x + linear(o, bp["proj"])
    h = _layer_norm(x, bp["norm2_w"], bp["norm2_b"], cfg.norm_eps)
    return x + linear(_act(linear(h, bp["fc1"]), cfg.activation), bp["fc2"])


def vit_forward(params, cfg: CLIPVisionConfig, images: torch.Tensor,
                use_31_block: bool = True) -> torch.Tensor:
    """images: [B, 3, H, W] normalized -> tokens [B, 1 + P, dim]."""
    b = images.shape[0]
    p = cfg.patch_size
    hh, ww = images.shape[2] // p, images.shape[3] // p
    x = images.reshape(b, 3, hh, p, ww, p).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, hh * ww, 3 * p * p)
    w = params["patch_embedding"]["weight"]
    tok = torch.matmul(x, w.reshape(w.shape[0], -1).to(x.dtype).t())
    if "bias" in params["patch_embedding"]:
        tok = tok + params["patch_embedding"]["bias"].to(x.dtype)
    cls = params["cls_embedding"].to(tok.dtype).expand(b, 1, tok.shape[-1])
    tok = torch.cat([cls, tok], dim=1)
    tok = tok + params["pos_embedding"].to(tok.dtype)
    if cfg.pre_norm:
        tok = _layer_norm(tok, params["pre_norm_w"], params["pre_norm_b"],
                          cfg.norm_eps)
    n_run = cfg.num_layers - 1 if use_31_block else cfg.num_layers
    for bp in params["blocks"][:n_run]:
        tok = _vit_block(bp, tok, cfg)
    return tok


def clip_encode_video_frames(params, cfg: CLIPVisionConfig,
                             videos: torch.Tensor) -> torch.Tensor:
    """`CLIPModel.forward` (`wan_image_encoder.py:513-528`): frames in
    [-1, 1] [B, 3, T, H, W] -> resize 224 bicubic -> CLIP-normalize ->
    penultimate-block tokens [B*T, 257, 1280]."""
    from flexam_tpu_torch.core.resize import resize
    b, c, t, h, w = videos.shape
    frames = videos.transpose(1, 2).reshape(b * t, c, h, w)
    frames = resize(frames, (b * t, c, cfg.image_size, cfg.image_size),
                    "bicubic")
    frames = frames.float() * 0.5 + 0.5
    mean = torch.tensor(CLIP_MEAN, device=frames.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=frames.device)[None, :, None, None]
    return vit_forward(params, cfg, ((frames - mean) / std).to(videos.dtype),
                       use_31_block=True)


def clip_image_embed(params, cfg: CLIPVisionConfig,
                     images: torch.Tensor) -> torch.Tensor:
    """HF ``CLIPVisionModelWithProjection.image_embeds``: full-depth tokens
    -> CLS -> post-layernorm -> bias-free visual projection. images:
    [B, 3, H, W], CLIP-normalized. Returns [B, proj_dim]."""
    tok = vit_forward(params, cfg, images, use_31_block=False)
    pooled = _layer_norm(tok[:, 0], params["post_norm_w"],
                         params["post_norm_b"], cfg.norm_eps)
    return linear(pooled, params["visual_projection"])


# ---------------------------------------------------------------------------
def _xlmr_block(bp, h, cfg: XLMRobertaConfig, k_len):
    b, s, c = h.shape
    n = cfg.num_heads
    q, k, v = (linear(h, bp[name]).reshape(b, s, n, c // n)
               for name in ("q", "k", "v"))
    attn_out = linear(exact_attention(q, k, v, k_len=k_len).reshape(b, s, c),
                      bp["o"])
    if cfg.post_norm:
        h = _layer_norm(h + attn_out, bp["norm1_w"], bp["norm1_b"], cfg.eps)
        ff = linear(F.gelu(linear(h, bp["fc1"])), bp["fc2"])
        return _layer_norm(h + ff, bp["norm2_w"], bp["norm2_b"], cfg.eps)
    h = h + attn_out
    return h + linear(F.gelu(linear(
        _layer_norm(h, bp["norm2_w"], bp["norm2_b"], cfg.eps), bp["fc1"])),
        bp["fc2"])


def xlm_roberta_forward(params, cfg: XLMRobertaConfig,
                        ids: torch.Tensor) -> torch.Tensor:
    """`XLMRoberta.forward` (`wan_xlm_roberta.py:118-130`): ids [B, L] ->
    [B, L, dim]; RoBERTa position ids from the cumulative sum of the
    padding mask, post-norm blocks, padded keys masked by their count."""
    mask = (ids != cfg.pad_id).long()
    pos = cfg.pad_id + torch.cumsum(mask, dim=1) * mask
    emb = params["token_embedding"]
    x = (emb[ids] + params["type_embedding"][torch.zeros_like(ids)]
         + params["pos_embedding"][pos]).to(emb.dtype)
    if cfg.post_norm:
        x = _layer_norm(x, params["norm_w"], params["norm_b"], cfg.eps)
    k_len = mask.sum(dim=1)
    for bp in params["blocks"]:
        x = _xlmr_block(bp, x, cfg, k_len)
    return x


# Params
# ---------------------------------------------------------------------------

def init_vit_params(cfg: CLIPVisionConfig, seed: int = 0,
                    dtype=torch.float32, device="cuda",
                    proj_dim: int = 0) -> dict:
    """Random parameters with the JAX init's distributions (normal / sqrt
    (dim) embeddings, xavier-uniform linears as `core.layers.linear_init`),
    drawn on the device; `proj_dim` > 0 adds the post-LN and projection of
    `clip_image_embed` (the HF head)."""
    import math
    dev = resolve_device(device)
    draw = ParamDraw(seed, dtype, dev)
    dim, mid = cfg.dim, int(cfg.dim * cfg.mlp_ratio)
    gain = dim ** -0.5
    n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1

    def lin(i, o, bias=True):
        limit = math.sqrt(6.0 / (i + o))
        w = torch.empty((o, i), device=dev).uniform_(-limit, limit,
                                                      generator=draw.gen)
        p = {"weight": w.to(dtype)}
        if bias:
            p["bias"] = draw.full((o,), 0.0)
        return p

    def block():
        return {"norm1_w": draw.full((dim,), 1.0),
                "norm1_b": draw.full((dim,), 0.0),
                "to_qkv": lin(dim, 3 * dim), "proj": lin(dim, dim),
                "norm2_w": draw.full((dim,), 1.0),
                "norm2_b": draw.full((dim,), 0.0),
                "fc1": lin(dim, mid), "fc2": lin(mid, dim)}

    p = {"patch_embedding": {"weight": draw.normal(
            (dim, 3, cfg.patch_size, cfg.patch_size), gain)},
         "cls_embedding": draw.normal((1, 1, dim), gain),
         "pos_embedding": draw.normal((1, n_pos, dim), gain),
         "blocks": [block() for _ in range(cfg.num_layers)]}
    if cfg.pre_norm:
        p["pre_norm_w"] = draw.full((dim,), 1.0)
        p["pre_norm_b"] = draw.full((dim,), 0.0)
    if proj_dim:
        p["post_norm_w"] = draw.full((dim,), 1.0)
        p["post_norm_b"] = draw.full((dim,), 0.0)
        p["visual_projection"] = lin(dim, proj_dim, bias=False)
    return p


def init_xlm_roberta_params(cfg: XLMRobertaConfig, seed: int = 0,
                            dtype=torch.float32, device="cuda") -> dict:
    """Random parameters with the JAX init's distributions (N(0, 0.02)
    embeddings, xavier-uniform linears with zero biases, unit / zero
    norms), drawn on the device."""
    dev = resolve_device(device)
    draw = ParamDraw(seed, dtype, dev)
    dim = cfg.dim
    kw = dict(dtype=dtype, device=dev)

    def block():
        lin = {n: linear_init(draw.gen, dim, dim, **kw)
               for n in ("q", "k", "v", "o")}
        return {**lin,
                "norm1_w": draw.full((dim,), 1.0),
                "norm1_b": draw.full((dim,), 0.0),
                "fc1": linear_init(draw.gen, dim, dim * 4, **kw),
                "fc2": linear_init(draw.gen, dim * 4, dim, **kw),
                "norm2_w": draw.full((dim,), 1.0),
                "norm2_b": draw.full((dim,), 0.0)}

    return {"token_embedding": draw.normal((cfg.vocab_size, dim), 0.02),
            "type_embedding": draw.normal((1, dim), 0.02),
            "pos_embedding": draw.normal((cfg.max_seq_len, dim), 0.02),
            "norm_w": draw.full((dim,), 1.0),
            "norm_b": draw.full((dim,), 0.0),
            "blocks": [block() for _ in range(cfg.num_layers)]}


def clip_vision_params_from_hf(sd: Mapping, num_heads: int = 16,
                               activation: str = "gelu", dtype=torch.float32,
                               device="cuda"
                               ) -> Tuple[dict, CLIPVisionConfig, dict]:
    """Map an HF ``CLIPVisionModelWithProjection`` state dict
    (``vision_model.*`` + ``visual_projection``) onto the tower, on
    `device` in `dtype`. Geometry comes from the shapes; ``num_heads`` and
    ``activation`` from the model's config.json. Returns (params, cfg,
    coverage report); params is {} when anything is missing, as in JAX."""
    from flexam_tpu_torch.io.checkpoints import _source
    from flexam_tpu_torch.io.convert import leaf
    dev = resolve_device(device)
    alias = {}
    for a, b in (("vision_model.pre_layernorm.weight",
                  "vision_model.pre_layrnorm.weight"),
                 ("vision_model.pre_layernorm.bias",
                  "vision_model.pre_layrnorm.bias")):
        if a in sd and b not in sd:
            alias[b] = a          # HF spells the attribute `pre_layrnorm`
    keys = (set(sd) - set(alias.values())) | set(alias)
    loaded, missed = [], []

    def g(k):
        if k in keys:
            loaded.append(k)
            return leaf(_source(sd, alias.get(k, k))[0], dev, dtype)
        missed.append(k)
        return None

    def report(extra=()):
        return {"loaded": loaded, "missed": missed + list(extra),
                "unused": sorted(keys - set(loaded))}

    cls = g("vision_model.embeddings.class_embedding")
    pw = g("vision_model.embeddings.patch_embedding.weight")
    pos = g("vision_model.embeddings.position_embedding.weight")
    if cls is None or pw is None or pos is None:
        return {}, CLIPVisionConfig(), report(["<geometry>"])
    dim, patch, n_pos = cls.numel(), pw.shape[-1], pos.shape[0]
    n_layers = 1 + max((int(k.split(".")[3]) for k in keys
                        if k.startswith("vision_model.encoder.layers.")),
                       default=-1)
    cfg = CLIPVisionConfig(image_size=patch * int(round((n_pos - 1) ** 0.5)),
                           patch_size=patch, dim=dim, num_heads=num_heads,
                           num_layers=n_layers, activation=activation,
                           pre_norm=True)
    blocks = []
    for i in range(n_layers):
        pfx = f"vision_model.encoder.layers.{i}"
        qkv_w = [g(f"{pfx}.self_attn.{n}_proj.weight") for n in "qkv"]
        qkv_b = [g(f"{pfx}.self_attn.{n}_proj.bias") for n in "qkv"]
        blk = {"norm1_w": g(f"{pfx}.layer_norm1.weight"),
               "norm1_b": g(f"{pfx}.layer_norm1.bias"),
               "proj": {"weight": g(f"{pfx}.self_attn.out_proj.weight"),
                        "bias": g(f"{pfx}.self_attn.out_proj.bias")},
               "norm2_w": g(f"{pfx}.layer_norm2.weight"),
               "norm2_b": g(f"{pfx}.layer_norm2.bias"),
               "fc1": {"weight": g(f"{pfx}.mlp.fc1.weight"),
                       "bias": g(f"{pfx}.mlp.fc1.bias")},
               "fc2": {"weight": g(f"{pfx}.mlp.fc2.weight"),
                       "bias": g(f"{pfx}.mlp.fc2.bias")}}
        if all(t is not None for t in qkv_w + qkv_b):
            blk["to_qkv"] = {"weight": torch.cat(qkv_w, 0),
                             "bias": torch.cat(qkv_b, 0)}
        blocks.append(blk)
    if any(any(t is None for t in _leaves(b)) or "to_qkv" not in b
           for b in blocks):
        return {}, cfg, report()
    params = {
        "patch_embedding": {"weight": pw},
        "cls_embedding": cls.reshape(1, 1, dim),
        "pos_embedding": pos.reshape(1, n_pos, dim),
        "pre_norm_w": g("vision_model.pre_layrnorm.weight"),
        "pre_norm_b": g("vision_model.pre_layrnorm.bias"),
        "post_norm_w": g("vision_model.post_layernorm.weight"),
        "post_norm_b": g("vision_model.post_layernorm.bias"),
        "visual_projection": {"weight": g("visual_projection.weight")},
        "blocks": blocks,
    }
    return ({} if missed else params), cfg, report()


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def clip_vision_state_dict(params: dict) -> dict:
    """The inverse of `clip_vision_params_from_hf`: HF
    ``CLIPVisionModelWithProjection`` names (tensors as stored), for
    `io.checkpoints.save_safetensors`."""
    out = {"vision_model.embeddings.class_embedding":
           params["cls_embedding"].reshape(-1),
           "vision_model.embeddings.patch_embedding.weight":
           params["patch_embedding"]["weight"],
           "vision_model.embeddings.position_embedding.weight":
           params["pos_embedding"][0],
           "vision_model.pre_layrnorm.weight": params["pre_norm_w"],
           "vision_model.pre_layrnorm.bias": params["pre_norm_b"],
           "vision_model.post_layernorm.weight": params["post_norm_w"],
           "vision_model.post_layernorm.bias": params["post_norm_b"],
           "visual_projection.weight": params["visual_projection"]["weight"]}
    for i, bp in enumerate(params["blocks"]):
        pfx = f"vision_model.encoder.layers.{i}"
        for n, w, b in zip("qkv", bp["to_qkv"]["weight"].chunk(3),
                           bp["to_qkv"]["bias"].chunk(3)):
            out[f"{pfx}.self_attn.{n}_proj.weight"] = w
            out[f"{pfx}.self_attn.{n}_proj.bias"] = b
        for ours, hf in (("proj", "self_attn.out_proj"), ("fc1", "mlp.fc1"),
                         ("fc2", "mlp.fc2")):
            out[f"{pfx}.{hf}.weight"] = bp[ours]["weight"]
            out[f"{pfx}.{hf}.bias"] = bp[ours]["bias"]
        for n in ("1", "2"):
            out[f"{pfx}.layer_norm{n}.weight"] = bp[f"norm{n}_w"]
            out[f"{pfx}.layer_norm{n}.bias"] = bp[f"norm{n}_b"]
    return out


def vit_params_from_state_dict(sd: Mapping, cfg: CLIPVisionConfig,
                               device="cuda") -> dict:
    """Map the reference `VisionTransformer` state_dict (prefix 'visual.'
    inside XLMRobertaCLIP, or none), float32 on `device`."""
    from flexam_tpu_torch.io.checkpoints import _source
    from flexam_tpu_torch.io.convert import leaf
    dev = resolve_device(device)

    def g(k):
        return leaf(_source(sd, k)[0], dev, torch.float32)

    def lin(k):
        return {"weight": g(f"{k}.weight"), "bias": g(f"{k}.bias")}

    blocks = [{"norm1_w": g(f"transformer.{i}.norm1.weight"),
               "norm1_b": g(f"transformer.{i}.norm1.bias"),
               "to_qkv": lin(f"transformer.{i}.attn.to_qkv"),
               "proj": lin(f"transformer.{i}.attn.proj"),
               "norm2_w": g(f"transformer.{i}.norm2.weight"),
               "norm2_b": g(f"transformer.{i}.norm2.bias"),
               "fc1": lin(f"transformer.{i}.mlp.0"),
               "fc2": lin(f"transformer.{i}.mlp.2")}
              for i in range(cfg.num_layers)]
    p = {"patch_embedding": {"weight": g("patch_embedding.weight")},
         "cls_embedding": g("cls_embedding"),
         "pos_embedding": g("pos_embedding"), "blocks": blocks}
    if "patch_embedding.bias" in sd:
        p["patch_embedding"]["bias"] = g("patch_embedding.bias")
    if cfg.pre_norm:
        p["pre_norm_w"] = g("pre_norm.weight")
        p["pre_norm_b"] = g("pre_norm.bias")
    return p
