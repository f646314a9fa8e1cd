"""FLUX.1 rectified-flow transformer (MMDiT).

Port of `flexam_tpu/models/flux.py`: 19 double-stream (img/txt) blocks and
38 single-stream blocks, 3-axis rotary embeddings (axes_dim 16/56/56 over
[t, h, w] ids, interleaved pairs), RMS-normalized q/k over head_dim,
timestep + pooled-CLIP + distilled-guidance modulation, 2x2 latent patch
packing. FLUX.1-Depth-dev takes the packed control latents channel-
concatenated to the packed noisy latents (`in_channels` 128 = 64 + 64).

The JAX module scans stacked blocks; the port keeps one dict a block in
the lists `double_blocks` / `single_blocks` (`io/convert.py` crosses the
layouts) and loops over them. The joint attention over cat(txt, img)
goes through `core.attention.attention`: at head_dim 128 on the card
that is B1 (`csrc/flash_attention.cu`); the LayerNorm + modulation, the
q/k RMSNorm and the RoPE are XLA work in JAX, so plain torch here.

Weights load from the BFL single-file layout (`flux1-depth-dev.safetensors`:
`double_blocks.N.img_attn.qkv.weight`, `single_blocks.N.linear1.weight`,
...) through the same exact name map as JAX's, with its coverage report
for `io/verify_load.check_mapping`; `flux_state_dict` writes the inverse.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from flexam_tpu_torch.core.attention import attention
from flexam_tpu_torch.core.layers import (ParamDraw, gelu_tanh, layer_norm,
                                          rms_norm, silu)
from flexam_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    """FLUX.1-dev geometry. ``in_channels=128`` selects the Control
    (channel-concat conditioning) variant; base generation uses 64."""

    in_channels: int = 128
    out_channels: int = 64
    vec_dim: int = 768           # pooled CLIP-L
    context_dim: int = 4096      # T5-XXL hidden
    hidden: int = 3072
    mlp_ratio: float = 4.0
    num_heads: int = 24
    depth_double: int = 19
    depth_single: int = 38
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: int = 10000
    guidance_embed: bool = True  # dev models are guidance-distilled
    patch: int = 2               # latent 2x2 patch packing
    vae_channels: int = 16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads

    @classmethod
    def tiny(cls, in_channels: int = 32) -> "FluxConfig":
        """Test geometry: head_dim 16 = 4+6+6, 2 double + 4 single."""
        return cls(in_channels=in_channels, out_channels=16, vec_dim=24,
                   context_dim=32, hidden=64, num_heads=4,
                   depth_double=2, depth_single=4, axes_dim=(4, 6, 6),
                   vae_channels=4)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       time_factor: float = 1000.0) -> torch.Tensor:
    """Sinusoidal embedding of t in [0, 1]: [cos | sin] halves (the FLUX
    convention: cos first, t scaled by 1000), fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * time_factor * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_tables(ids: torch.Tensor, axes_dim: Tuple[int, ...],
                theta: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [L, sum(axes_dim)//2] fp32, for integer position
    ids [L, n_axes]: axis i rotates its own axes_dim[i]//2 frequencies."""
    parts_c, parts_s = [], []
    pos = ids.float()
    for i, d in enumerate(axes_dim):
        omega = 1.0 / (theta ** (torch.arange(
            0, d, 2, dtype=torch.float32, device=ids.device) / d))
        out = pos[:, i][:, None] * omega[None]
        parts_c.append(torch.cos(out))
        parts_s.append(torch.sin(out))
    return torch.cat(parts_c, -1), torch.cat(parts_s, -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation of x [B, L, H, D] by cos/sin [L, D/2]:
    even' = even*cos - odd*sin, odd' = even*sin + odd*cos, in fp32."""
    xf = x.float().unflatten(-1, (-1, 2))
    c = cos.float()[None, :, None, :]
    s = sin.float()[None, :, None, :]
    even, odd = xf[..., 0], xf[..., 1]
    rot = torch.stack([even * c - odd * s, even * s + odd * c], dim=-1)
    return rot.flatten(-2).to(x.dtype)


def _lin(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.to(x.dtype).t()) + b.to(x.dtype)


def _mlp_embed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """MLPEmbedder: out_layer(silu(in_layer(x)))."""
    return _lin(p["out_w"], p["out_b"], silu(_lin(p["in_w"], p["in_b"], x)))


def _qk_norm(q, k, p):
    """RMSNorm over head_dim with the learned scales, fp32 statistics."""
    return (rms_norm(q, p["q_scale"]).to(q.dtype),
            rms_norm(k, p["k_scale"]).to(k.dtype))


def _modulate(x, scale, shift):
    return layer_norm(x) * (1 + scale) + shift


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads)


def _double_block(bp: dict, img, txt, vec, cos, sin, cfg: FluxConfig):
    """One double-stream block: separate img/txt qkv and MLPs, joint
    attention over cat(txt, img) with RoPE, gated residuals (six
    modulation chunks a stream: shift1, scale1, gate1, shift2, scale2,
    gate2)."""
    dt = img.dtype
    n_txt = txt.shape[1]
    sv = silu(vec)
    i_mod = _lin(bp["img_mod_w"], bp["img_mod_b"], sv)[:, None]
    t_mod = _lin(bp["txt_mod_w"], bp["txt_mod_b"], sv)[:, None]
    i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = i_mod.chunk(6, -1)
    t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = t_mod.chunk(6, -1)

    iq, ik, iv = _lin(bp["img_qkv_w"], bp["img_qkv_b"],
                      _modulate(img, i_sc1, i_sh1)).chunk(3, -1)
    tq, tk, tv = _lin(bp["txt_qkv_w"], bp["txt_qkv_b"],
                      _modulate(txt, t_sc1, t_sh1)).chunk(3, -1)
    iq, ik, iv = (_heads(x, cfg.num_heads) for x in (iq, ik, iv))
    tq, tk, tv = (_heads(x, cfg.num_heads) for x in (tq, tk, tv))
    iq, ik = _qk_norm(iq, ik, bp["img_attn_norm"])
    tq, tk = _qk_norm(tq, tk, bp["txt_attn_norm"])

    q = apply_rope(torch.cat([tq, iq], 1), cos, sin)      # txt tokens first
    k = apply_rope(torch.cat([tk, ik], 1), cos, sin)
    v = torch.cat([tv, iv], 1).contiguous()
    out = attention(q, k, v)
    out = out.reshape(out.shape[0], out.shape[1], -1).to(dt)
    txt_attn, img_attn = out[:, :n_txt], out[:, n_txt:]

    img = img + i_g1 * _lin(bp["img_proj_w"], bp["img_proj_b"], img_attn)
    h = gelu_tanh(_lin(bp["img_mlp0_w"], bp["img_mlp0_b"],
                       _modulate(img, i_sc2, i_sh2)))
    img = img + i_g2 * _lin(bp["img_mlp2_w"], bp["img_mlp2_b"], h)

    txt = txt + t_g1 * _lin(bp["txt_proj_w"], bp["txt_proj_b"], txt_attn)
    h = gelu_tanh(_lin(bp["txt_mlp0_w"], bp["txt_mlp0_b"],
                       _modulate(txt, t_sc2, t_sh2)))
    txt = txt + t_g2 * _lin(bp["txt_mlp2_w"], bp["txt_mlp2_b"], h)
    return img, txt


def _single_block(bp: dict, x, vec, cos, sin, cfg: FluxConfig):
    """One single-stream block: linear1 -> (qkv | mlp), attention with RoPE
    over the whole (txt + img) sequence, linear2 over cat(attn,
    gelu(mlp)), one gated residual."""
    dt = x.dtype
    sh, sc, gate = _lin(bp["mod_w"], bp["mod_b"],
                        silu(vec))[:, None].chunk(3, -1)
    proj = _lin(bp["lin1_w"], bp["lin1_b"], _modulate(x, sc, sh))
    qkv, mlp = proj[..., :3 * cfg.hidden], proj[..., 3 * cfg.hidden:]
    q, k, v = (_heads(t, cfg.num_heads) for t in qkv.chunk(3, -1))
    q, k = _qk_norm(q, k, bp["attn_norm"])
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    out = attention(q, k, v.contiguous())
    out = out.reshape(out.shape[0], out.shape[1], -1).to(dt)
    cat = torch.cat([out, gelu_tanh(mlp)], dim=-1)
    return x + gate * _lin(bp["lin2_w"], bp["lin2_b"], cat)


def flux_forward(params: dict, cfg: FluxConfig, img: torch.Tensor,
                 img_ids: torch.Tensor, txt: torch.Tensor,
                 txt_ids: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                 guidance: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rectified-flow velocity of packed latent tokens.

    img: [B, L_img, in_channels] packed (2x2 patch) latent tokens (for the
    Control variant already channel-concatenated with the packed control
    latents); img_ids: [L_img, 3] integer (t, h, w); txt: [B, L_txt,
    context_dim] T5 features; txt_ids: [L_txt, 3]; t: [B] in [0, 1];
    y: [B, vec_dim] pooled CLIP; guidance: [B]. Returns [B, L_img,
    out_channels]."""
    dt = img.dtype
    x = _lin(params["img_in_w"], params["img_in_b"], img)
    vec = _mlp_embed(params["time_in"], timestep_embedding(t, 256).to(dt))
    if cfg.guidance_embed:
        if guidance is None:
            raise ValueError("guidance_embed model needs a guidance value")
        vec = vec + _mlp_embed(params["guidance_in"],
                               timestep_embedding(guidance, 256).to(dt))
    vec = vec + _mlp_embed(params["vector_in"], y.to(dt))
    txt = _lin(params["txt_in_w"], params["txt_in_b"], txt)

    ids = torch.cat([txt_ids, img_ids], dim=0)            # txt first
    cos, sin = rope_tables(ids, cfg.axes_dim, cfg.theta)
    for bp in params["double_blocks"]:
        x, txt = _double_block(bp, x, txt, vec, cos, sin, cfg)
    seq = torch.cat([txt, x], dim=1)
    for bp in params["single_blocks"]:
        seq = _single_block(bp, seq, vec, cos, sin, cfg)
    x = seq[:, txt.shape[1]:]
    f_sh, f_sc = _lin(params["final_mod_w"], params["final_mod_b"],
                      silu(vec))[:, None].chunk(2, -1)
    return _lin(params["final_w"], params["final_b"], _modulate(x, f_sc, f_sh))


# ---------------------------------------------------------------------------
# Packing (2x2 latent patches <-> tokens) and position ids
# ---------------------------------------------------------------------------

def pack_latents(z: torch.Tensor, patch: int = 2) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/p)*(W/p), C*p*p] (the ``c (h ph) (w pw) ->
    (h w) (c ph pw)`` convention)."""
    b, c, h, w = z.shape
    z = z.reshape(b, c, h // patch, patch, w // patch, patch)
    z = z.permute(0, 2, 4, 1, 3, 5)
    return z.reshape(b, (h // patch) * (w // patch), c * patch * patch)


def unpack_latents(tokens: torch.Tensor, h: int, w: int,
                   patch: int = 2) -> torch.Tensor:
    """Inverse of pack_latents: [B, L, C*p*p] -> [B, C, H, W]."""
    b, _, d = tokens.shape
    c = d // (patch * patch)
    z = tokens.reshape(b, h // patch, w // patch, c, patch, patch)
    z = z.permute(0, 3, 1, 4, 2, 5)
    return z.reshape(b, c, h, w)


def make_img_ids(h: int, w: int, patch: int = 2) -> np.ndarray:
    """[L, 3] integer ids (0, row, col) for the packed token grid."""
    hh, ww = h // patch, w // patch
    ids = np.zeros((hh, ww, 3), np.int32)
    ids[..., 1] = np.arange(hh)[:, None]
    ids[..., 2] = np.arange(ww)[None, :]
    return ids.reshape(hh * ww, 3)


def flux_schedule(num_steps: int, image_seq_len: int,
                  base_shift: float = 0.5, max_shift: float = 1.15,
                  shift: bool = True) -> np.ndarray:
    """Resolution-shifted sigma schedule, 1 -> 0 (num_steps+1 points):
    sigma' = e^mu / (e^mu + 1/sigma - 1) with mu linear in seq_len
    between (256, base_shift) and (4096, max_shift)."""
    ts = np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float64)
    if shift:
        m = (max_shift - base_shift) / (4096 - 256)
        mu = m * image_seq_len + (base_shift - 256 * m)
        with np.errstate(divide="ignore"):
            ts = np.exp(mu) / (np.exp(mu) + (1.0 / ts - 1.0))
        ts[0], ts[-1] = 1.0, 0.0
    return ts.astype(np.float32)


# ---------------------------------------------------------------------------
# Params: init, the BFL name map, its inverse
# ---------------------------------------------------------------------------

def _flux_tree(cfg: FluxConfig, draw: ParamDraw) -> dict:
    """The parameter tree with JAX's keys and shapes (LeCun-normal linears,
    zero biases, unit q/k scales), one dict a block."""
    h, mlp_h, hd = cfg.hidden, int(cfg.hidden * cfg.mlp_ratio), cfg.head_dim

    def lin(o, i):
        return draw.normal((o, i), i ** -0.5), draw.full((o,), 0.0)

    def embed(i):
        iw, ib = lin(h, i)
        ow, ob = lin(h, h)
        return {"in_w": iw, "in_b": ib, "out_w": ow, "out_b": ob}

    def norm():
        return {"q_scale": draw.full((hd,), 1.0),
                "k_scale": draw.full((hd,), 1.0)}

    def dbl():
        p = {}
        for s in ("img", "txt"):
            for name, o, i in (("qkv", 3 * h, h), ("proj", h, h),
                               ("mlp0", mlp_h, h), ("mlp2", h, mlp_h),
                               ("mod", 6 * h, h)):
                p[f"{s}_{name}_w"], p[f"{s}_{name}_b"] = lin(o, i)
            p[f"{s}_attn_norm"] = norm()
        return p

    def sgl():
        p = {}
        for name, o, i in (("lin1", 3 * h + mlp_h, h), ("lin2", h, h + mlp_h),
                           ("mod", 3 * h, h)):
            p[f"{name}_w"], p[f"{name}_b"] = lin(o, i)
        p["attn_norm"] = norm()
        return p

    p = {}
    p["img_in_w"], p["img_in_b"] = lin(h, cfg.in_channels)
    p["txt_in_w"], p["txt_in_b"] = lin(h, cfg.context_dim)
    p["final_w"], p["final_b"] = lin(cfg.out_channels, h)
    p["final_mod_w"], p["final_mod_b"] = lin(2 * h, h)
    p["time_in"] = embed(256)
    p["vector_in"] = embed(cfg.vec_dim)
    p["double_blocks"] = [dbl() for _ in range(cfg.depth_double)]
    p["single_blocks"] = [sgl() for _ in range(cfg.depth_single)]
    if cfg.guidance_embed:
        p["guidance_in"] = embed(256)
    return p


def init_flux_params(cfg: FluxConfig, seed: int = 0, dtype=torch.bfloat16,
                     device="cuda") -> dict:
    """Random parameters with the JAX init's distributions, drawn on the
    device from a `torch.Generator` seeded with `seed`."""
    return _flux_tree(cfg, ParamDraw(seed, dtype, resolve_device(device)))


def _bfl_names(cfg: FluxConfig) -> Dict[str, tuple]:
    """BFL checkpoint key -> tree path; block entries are
    ('double_blocks', i, leaf...) / ('single_blocks', i, leaf...)."""
    names: Dict[str, tuple] = {
        "img_in.weight": ("img_in_w",), "img_in.bias": ("img_in_b",),
        "txt_in.weight": ("txt_in_w",), "txt_in.bias": ("txt_in_b",),
        "final_layer.linear.weight": ("final_w",),
        "final_layer.linear.bias": ("final_b",),
        "final_layer.adaLN_modulation.1.weight": ("final_mod_w",),
        "final_layer.adaLN_modulation.1.bias": ("final_mod_b",),
    }
    for mod in ("time_in", "vector_in", "guidance_in"):
        if mod == "guidance_in" and not cfg.guidance_embed:
            continue
        for sd_leaf, leaf in (("in_layer.weight", "in_w"),
                              ("in_layer.bias", "in_b"),
                              ("out_layer.weight", "out_w"),
                              ("out_layer.bias", "out_b")):
            names[f"{mod}.{sd_leaf}"] = (mod, leaf)
    for i in range(cfg.depth_double):
        b, d = f"double_blocks.{i}", ("double_blocks", i)
        for s in ("img", "txt"):
            for wb in ("weight", "bias"):
                x = wb[0]
                names.update({
                    f"{b}.{s}_mod.lin.{wb}": d + (f"{s}_mod_{x}",),
                    f"{b}.{s}_attn.qkv.{wb}": d + (f"{s}_qkv_{x}",),
                    f"{b}.{s}_attn.proj.{wb}": d + (f"{s}_proj_{x}",),
                    f"{b}.{s}_mlp.0.{wb}": d + (f"{s}_mlp0_{x}",),
                    f"{b}.{s}_mlp.2.{wb}": d + (f"{s}_mlp2_{x}",),
                })
            names[f"{b}.{s}_attn.norm.query_norm.scale"] = d + (
                f"{s}_attn_norm", "q_scale")
            names[f"{b}.{s}_attn.norm.key_norm.scale"] = d + (
                f"{s}_attn_norm", "k_scale")
    for i in range(cfg.depth_single):
        b, d = f"single_blocks.{i}", ("single_blocks", i)
        for wb in ("weight", "bias"):
            x = wb[0]
            names.update({
                f"{b}.linear1.{wb}": d + (f"lin1_{x}",),
                f"{b}.linear2.{wb}": d + (f"lin2_{x}",),
                f"{b}.modulation.lin.{wb}": d + (f"mod_{x}",),
            })
        names[f"{b}.norm.query_norm.scale"] = d + ("attn_norm", "q_scale")
        names[f"{b}.norm.key_norm.scale"] = d + ("attn_norm", "k_scale")
    return names


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _set(tree, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {}) if isinstance(tree, dict) else tree[p]
    tree[path[-1]] = value


def flux_params_from_state_dict(sd: Mapping, cfg: FluxConfig,
                                dtype=torch.float32, device="cuda"
                                ) -> Tuple[dict, Dict[str, list]]:
    """The exact BFL name map: the port's tree on `device`, each tensor
    cast to `dtype` there (JAX reads float32 and its repainter casts to
    its dtype: the same values), and the coverage report ({"loaded",
    "missed", "unused"}, paths joined by "/") for
    `io/verify_load.check_mapping`. A
    tensor of the wrong shape (a 64-channel flux1-dev file against the
    128-channel Control config) counts as missed, as in JAX."""
    from flexam_tpu_torch.io.checkpoints import _source
    from flexam_tpu_torch.io.convert import leaf
    dev = resolve_device(device)
    names = _bfl_names(cfg)
    template = _flux_tree(cfg, ParamDraw(0, device="meta"))
    params: dict = {"double_blocks": [{} for _ in range(cfg.depth_double)],
                    "single_blocks": [{} for _ in range(cfg.depth_single)]}
    loaded, missed = [], []
    for key, path in names.items():
        tag = "/".join(str(p) for p in path)
        if key not in sd:
            missed.append(tag)
            continue
        t = _source(sd, key)[0]
        if tuple(t.shape) != tuple(_get(template, path).shape):
            missed.append(tag)
            continue
        _set(params, path, leaf(t, dev, dtype))
        loaded.append(tag)
    unused = [k for k in sd if k not in names]
    return params, {"loaded": loaded, "missed": missed, "unused": unused}


def flux_state_dict(params: dict, cfg: FluxConfig) -> Dict[str, torch.Tensor]:
    """The inverse of the name map: BFL-named tensors (as stored in
    `params`) for `io.checkpoints.save_safetensors`."""
    return {key: _get(params, path) for key, path in _bfl_names(cfg).items()}
