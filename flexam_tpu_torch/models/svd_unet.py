"""SVD-family spatio-temporal UNet (DepthCrafter's denoiser).

Port of `flexam_tpu/models/svd_unet.py`: the published Stable Video
Diffusion UNet, a 2D UNet whose every resnet and transformer has a
temporal twin and a learned alpha blender, conditioned on CLIP image
embeddings and (fps, motion bucket, noise-aug) time ids, denoising by EDM
v-prediction over Karras sigmas.

Layout: JAX runs [B, T, H, W, C] with NHWC convs; the port runs frames as
[B*T, C, H, W] (NCHW, cuDNN) and the temporal twins over [B, C, T, H, W]
with a (3, 1, 1) conv3d, so GroupNorm takes its statistics over all T
frames there, as in JAX. Kernels are OIHW / OIDHW (the published layout;
`io/convert.py` transposes JAX's trees). JAX's "SAME" padding of the
stride-2 downsample puts the odd pixel at the high end: `_conv2d` pads
likewise. Spatial attention runs at [B*T, H*W, C], temporal at
[B*H*W, T, C], both through `core.attention.attention`: every head is 64
wide, so both take the exact branch (`exact_attention`, byte-bounded in
`ops/flash_attention.attention_plain`).

The tree mirrors the published module naming level by level
(`down_blocks.0.resnets.1.spatial_res_block.conv1`), so the loader is one
generic name map with a coverage report, as JAX's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flexam_tpu_torch.core.attention import attention
from flexam_tpu_torch.core.layers import (ParamDraw, gelu_tanh, group_norm,
                                          layer_norm, silu)
from flexam_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class SVDUNetConfig:
    in_channels: int = 8            # 4 noisy + 4 conditioning latents
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    addition_time_embed_dim: int = 256
    num_additional_ids: int = 3     # fps, motion bucket, noise-aug
    norm_groups: int = 32

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @classmethod
    def tiny(cls) -> "SVDUNetConfig":
        return cls(block_out_channels=(32, 64), layers_per_block=1,
                   cross_attention_dim=48, num_attention_heads=(2, 4),
                   addition_time_embed_dim=16)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def _conv2d(x, p, stride=1):
    """x: [N, C, H, W]; p["weight"]: OIHW; JAX's SAME padding (the extra
    pixel of a stride-2 window at the high end)."""
    w = p["weight"].to(x.dtype)
    k = w.shape[-1]
    if stride == 1:
        return F.conv2d(x, w, p["bias"].to(x.dtype), padding=k // 2)
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, p["bias"].to(x.dtype), stride=stride)


def _conv_t(x, p):
    """Temporal conv, kernel (3, 1, 1), over x [B, C, T, H, W]."""
    return F.conv3d(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype),
                    padding=(1, 0, 0))


def _lin(x, p):
    return torch.matmul(x, p["weight"].to(x.dtype).t()) + p["bias"].to(
        x.dtype)


def _gn(x, p, groups):
    return group_norm(x, p["weight"], p["bias"], num_groups=groups, eps=1e-5)


def _ln(x, p):
    return layer_norm(x, p["weight"], p["bias"], eps=1e-5)


def sinusoidal_timestep(t: torch.Tensor, dim: int,
                        max_period: float = 10000.0) -> torch.Tensor:
    """flip_sin_to_cos=True, downscale_freq_shift=0 (the published
    convention): [cos | sin], fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _alpha_blend(p, spatial, temporal):
    """Learned spatio-temporal mix: sigmoid(mix_factor) weights the SPATIAL
    branch (strategy "learned_with_images", video path)."""
    a = torch.sigmoid(p["mix_factor"].float()).to(spatial.dtype)
    return a * spatial + (1 - a) * temporal


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _resnet2d(x, temb, p, groups):
    """Spatial resnet over [N, C, H, W]; the time-embedding shift only
    where the block has one (the temporal decoder's resnets do not)."""
    h = _conv2d(silu(_gn(x, p["norm1"], groups)), p["conv1"])
    if temb is not None and "time_emb_proj" in p:
        h = h + _lin(silu(temb), p["time_emb_proj"])[:, :, None, None]
    h = _conv2d(silu(_gn(h, p["norm2"], groups)), p["conv2"])
    if "conv_shortcut" in p:
        x = _conv2d(x, p["conv_shortcut"])
    return x + h


def _resnet_temporal(x, temb_t, p, groups):
    """Temporal resnet over [B, C, T, H, W] (3-tap conv along T); temb_t:
    [B, T, D] or None."""
    h = _conv_t(silu(_gn(x, p["norm1"], groups)), p["conv1"])
    if temb_t is not None and "time_emb_proj" in p:
        h = h + _lin(silu(temb_t), p["time_emb_proj"]).transpose(
            1, 2)[..., None, None]
    h = _conv_t(silu(_gn(h, p["norm2"], groups)), p["conv2"])
    return x + h


def _st_resblock(x, temb, p, groups, b, t):
    """SpatioTemporalResBlock: spatial resnet -> temporal resnet -> learned
    alpha blend. x: [B*T, C, H, W], temb: [B*T, D] or None."""
    s = _resnet2d(x, temb, p["spatial_res_block"], groups)
    bt, c, hh, ww = s.shape
    s5 = s.reshape(b, t, c, hh, ww).transpose(1, 2)        # [B, C, T, H, W]
    tt = _resnet_temporal(s5, None if temb is None else temb.reshape(b, t, -1),
                          p["temporal_res_block"], groups)
    return _alpha_blend(p["time_mixer"], s5, tt).transpose(1, 2).reshape(
        bt, c, hh, ww)


def _mha(x, ctx, p, heads):
    """Multi-head attention in the published to_q/to_k/to_v/to_out naming;
    x [N, L, C], ctx [N, Lk, C_ctx]."""
    n, l, c = x.shape
    d = c // heads
    q = _lin(x, p["to_q"]).reshape(n, l, heads, d)
    k = _lin(ctx, p["to_k"]).reshape(n, ctx.shape[1], heads, d)
    v = _lin(ctx, p["to_v"]).reshape(n, ctx.shape[1], heads, d)
    o = attention(q, k, v).reshape(n, l, c).to(x.dtype)
    return _lin(o, p["to_out"])


def _geglu_ff(x, p):
    a, g = _lin(x, p["net_in"]).chunk(2, dim=-1)
    return _lin(a * gelu_tanh(g), p["net_out"])


def _basic_block(x, ctx, p, heads):
    """Spatial transformer block: self-attn, cross-attn, GEGLU ff."""
    h = _ln(x, p["norm1"])
    x = x + _mha(h, h, p["attn1"], heads)
    x = x + _mha(_ln(x, p["norm2"]), ctx, p["attn2"], heads)
    return x + _geglu_ff(_ln(x, p["norm3"]), p["ff"])


def _temporal_block(x, ctx, p, heads):
    """Temporal transformer block (ff_in + self over T + cross + ff)."""
    x = _geglu_ff(_ln(x, p["norm_in"]), p["ff_in"]) + x
    h = _ln(x, p["norm1"])
    x = x + _mha(h, h, p["attn1"], heads)
    x = x + _mha(_ln(x, p["norm2"]), ctx, p["attn2"], heads)
    return x + _geglu_ff(_ln(x, p["norm3"]), p["ff"])


def _st_transformer(x, ctx, p, groups, heads, b, t):
    """TransformerSpatioTemporalModel: spatial blocks and their temporal
    twins with a frame positional embedding and learned mixing.
    x: [B*T, C, H, W]; ctx: [B*T, L, cross_dim]."""
    bt, c, hh, ww = x.shape
    hw = hh * ww
    h = _gn(x, p["norm"], groups).flatten(2).transpose(1, 2)   # [BT, HW, C]
    h = _lin(h, p["proj_in"])
    t_emb = sinusoidal_timestep(torch.arange(t, device=x.device), c)
    t_emb = _lin(silu(_lin(t_emb.to(h.dtype),
                           p["time_pos_embed"]["linear_1"])),
                 p["time_pos_embed"]["linear_2"])           # [T, C]
    ctx_t = ctx.reshape(b, t, ctx.shape[1], -1)[:, 0]       # first frame's
    ctx_t = ctx_t.repeat_interleave(hw, dim=0)
    for sp, tp in zip(p["transformer_blocks"],
                      p["temporal_transformer_blocks"]):
        h = _basic_block(h, ctx, sp, heads)
        # the temporal pass: its tokens are the T frames at each site
        h5 = h.reshape(b, t, hw, c) + t_emb[None, :, None, :]
        ht = h5.transpose(1, 2).reshape(b * hw, t, c)
        ht = _temporal_block(ht, ctx_t, tp, heads)
        ht = ht.reshape(b, hw, t, c).transpose(1, 2)
        h = _alpha_blend(p["time_mixer"], h.reshape(b, t, hw, c),
                         ht).reshape(bt, hw, c)
    h = _lin(h, p["proj_out"]).transpose(1, 2).reshape(bt, c, hh, ww)
    return h + x


# ---------------------------------------------------------------------------
# UNet forward
# ---------------------------------------------------------------------------

def svd_unet_forward(params: dict, cfg: SVDUNetConfig,
                     latents: torch.Tensor, timestep: torch.Tensor,
                     encoder_hidden_states: torch.Tensor,
                     added_time_ids: torch.Tensor) -> torch.Tensor:
    """latents: [B, T, in_channels, H, W] (noisy ++ conditioning);
    timestep: [B] (continuous c_noise); encoder_hidden_states:
    [B, T, L, cross_dim] CLIP image embeddings a frame; added_time_ids:
    [B, 3] (fps, motion bucket, noise aug). Returns the v-prediction
    [B, T, out_channels, H, W]."""
    b, t, _, hh, ww = latents.shape
    dt = latents.dtype
    g = cfg.norm_groups
    temb = sinusoidal_timestep(timestep, cfg.block_out_channels[0])
    temb = _lin(silu(_lin(temb.to(dt), params["time_embedding"]["linear_1"])),
                params["time_embedding"]["linear_2"])       # [B, D]
    add = sinusoidal_timestep(added_time_ids.reshape(-1),
                              cfg.addition_time_embed_dim).reshape(b, -1)
    add = _lin(silu(_lin(add.to(dt), params["add_embedding"]["linear_1"])),
               params["add_embedding"]["linear_2"])
    temb_bt = (temb + add).repeat_interleave(t, dim=0)      # [B*T, D]
    ctx = encoder_hidden_states.reshape(
        b * t, encoder_hidden_states.shape[2], -1).to(dt)

    x = _conv2d(latents.reshape(b * t, -1, hh, ww), params["conv_in"])
    heads = cfg.num_attention_heads
    skips = [x]
    for i, blk in enumerate(params["down_blocks"]):
        for j, rp in enumerate(blk["resnets"]):
            x = _st_resblock(x, temb_bt, rp, g, b, t)
            if "attentions" in blk:
                x = _st_transformer(x, ctx, blk["attentions"][j], g,
                                    heads[i], b, t)
            skips.append(x)
        if "downsamplers" in blk:
            x = _conv2d(x, blk["downsamplers"][0]["conv"], stride=2)
            skips.append(x)
    mid = params["mid_block"]
    x = _st_resblock(x, temb_bt, mid["resnets"][0], g, b, t)
    x = _st_transformer(x, ctx, mid["attentions"][0], g, heads[-1], b, t)
    x = _st_resblock(x, temb_bt, mid["resnets"][1], g, b, t)
    n_levels = len(cfg.block_out_channels)
    for i, blk in enumerate(params["up_blocks"]):
        for j, rp in enumerate(blk["resnets"]):
            x = _st_resblock(torch.cat([x, skips.pop()], dim=1), temb_bt, rp,
                             g, b, t)
            if "attentions" in blk:
                x = _st_transformer(x, ctx, blk["attentions"][j], g,
                                    heads[n_levels - 1 - i], b, t)
        if "upsamplers" in blk:
            x = _conv2d(F.interpolate(x, scale_factor=2, mode="nearest"),
                        blk["upsamplers"][0]["conv"])
    x = _conv2d(silu(_gn(x, params["conv_norm_out"], g)), params["conv_out"])
    return x.reshape(b, t, -1, hh, ww)


# ---------------------------------------------------------------------------
# Init (the published module tree; the loader is a generic map)
# ---------------------------------------------------------------------------

def _unet_tree(cfg: SVDUNetConfig, draw: ParamDraw) -> dict:
    """JAX's tree and distributions (normal / sqrt(fan_in) kernels and
    linears, zero biases, unit norms, mix factors 0.5), kernels OIHW."""
    def conv2(ci, co, k=3):
        return {"weight": draw.normal((co, ci, k, k), (ci * k * k) ** -0.5),
                "bias": draw.full((co,), 0.0)}

    def conv3(ci, co):
        return {"weight": draw.normal((co, ci, 3, 1, 1), (ci * 3) ** -0.5),
                "bias": draw.full((co,), 0.0)}

    def lin(ci, co):
        return {"weight": draw.normal((co, ci), ci ** -0.5),
                "bias": draw.full((co,), 0.0)}

    def norm(c):
        return {"weight": draw.full((c,), 1.0), "bias": draw.full((c,), 0.0)}

    ted = cfg.time_embed_dim

    def resnet2d(ci, co):
        p = {"norm1": norm(ci), "conv1": conv2(ci, co),
             "time_emb_proj": lin(ted, co),
             "norm2": norm(co), "conv2": conv2(co, co)}
        if ci != co:
            p["conv_shortcut"] = conv2(ci, co, k=1)
        return p

    def st_res(ci, co):
        return {"spatial_res_block": resnet2d(ci, co),
                "temporal_res_block": {
                    "norm1": norm(co), "conv1": conv3(co, co),
                    "time_emb_proj": lin(ted, co),
                    "norm2": norm(co), "conv2": conv3(co, co)},
                "time_mixer": {"mix_factor": draw.full((1,), 0.5)}}

    def mha(c, ctx_dim=None):
        return {"to_q": lin(c, c), "to_k": lin(ctx_dim or c, c),
                "to_v": lin(ctx_dim or c, c), "to_out": lin(c, c)}

    def ff(c):
        return {"net_in": lin(c, 8 * c), "net_out": lin(4 * c, c)}

    def basic(c):
        return {"norm1": norm(c), "attn1": mha(c),
                "norm2": norm(c), "attn2": mha(c, cfg.cross_attention_dim),
                "norm3": norm(c), "ff": ff(c)}

    def temporal(c):
        return {"norm_in": norm(c), "ff_in": ff(c), **basic(c)}

    def st_transformer(c):
        return {"norm": norm(c), "proj_in": lin(c, c),
                "transformer_blocks": [basic(c)],
                "temporal_transformer_blocks": [temporal(c)],
                "time_pos_embed": {"linear_1": lin(c, 4 * c),
                                   "linear_2": lin(4 * c, c)},
                "time_mixer": {"mix_factor": draw.full((1,), 0.5)},
                "proj_out": lin(c, c)}

    chans = cfg.block_out_channels
    params: dict = {
        "conv_in": conv2(cfg.in_channels, chans[0]),
        "time_embedding": {"linear_1": lin(chans[0], ted),
                           "linear_2": lin(ted, ted)},
        "add_embedding": {
            "linear_1": lin(cfg.addition_time_embed_dim
                            * cfg.num_additional_ids, ted),
            "linear_2": lin(ted, ted)},
        "down_blocks": [], "up_blocks": [],
        "conv_norm_out": norm(chans[0]),
        "conv_out": conv2(chans[0], cfg.out_channels)}
    ci = chans[0]
    skip_ch = [ci]
    for i, co in enumerate(chans):       # the last level: no attention,
        blk: dict = {"resnets": []}      # no downsampler
        has_attn = i < len(chans) - 1
        if has_attn:
            blk["attentions"] = []
        for _ in range(cfg.layers_per_block):
            blk["resnets"].append(st_res(ci, co))
            ci = co
            if has_attn:
                blk["attentions"].append(st_transformer(co))
            skip_ch.append(co)
        if i < len(chans) - 1:
            blk["downsamplers"] = [{"conv": conv2(co, co)}]
            skip_ch.append(co)
        params["down_blocks"].append(blk)
    params["mid_block"] = {
        "resnets": [st_res(chans[-1], chans[-1]),
                    st_res(chans[-1], chans[-1])],
        "attentions": [st_transformer(chans[-1])]}
    ci = chans[-1]
    for i in range(len(chans)):          # layers_per_block + 1 resnets,
        co = chans[len(chans) - 1 - i]   # channels mirror the down path
        has_attn = i > 0
        blk = {"resnets": []}
        if has_attn:
            blk["attentions"] = []
        for _ in range(cfg.layers_per_block + 1):
            blk["resnets"].append(st_res(ci + skip_ch.pop(), co))
            ci = co
            if has_attn:
                blk["attentions"].append(st_transformer(co))
        if i < len(chans) - 1:
            blk["upsamplers"] = [{"conv": conv2(co, co)}]
        params["up_blocks"].append(blk)
    return params


def init_svd_unet_params(cfg: SVDUNetConfig, seed: int = 0,
                         dtype=torch.float32, device="cuda") -> dict:
    """Random parameters with the JAX init's distributions, drawn on the
    device from a `torch.Generator` seeded with `seed`."""
    return _unet_tree(cfg, ParamDraw(seed, dtype, resolve_device(device)))


# ---------------------------------------------------------------------------
# Loader: the published naming, one generic map with a coverage report
# ---------------------------------------------------------------------------

_RENAMES = {
    # published torch naming -> this tree's naming
    "to_out.0": "to_out",
    "ff.net.0.proj": "ff.net_in",
    "ff.net.2": "ff.net_out",
    "ff_in.net.0.proj": "ff_in.net_in",
    "ff_in.net.2": "ff_in.net_out",
}


def flatten(tree, prefix=""):
    """{dotted path: leaf} in the tree's order (lists by index)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


def torch_name(ours: str) -> str:
    """A leaf's path in the published naming."""
    for a, b in _RENAMES.items():
        ours = ours.replace(b, a)
    return ours


def set_path(tree, dotted: str, value) -> None:
    parts = dotted.split(".")
    for p in parts[:-1]:
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    tree[parts[-1]] = value


def load_by_names(sd: Mapping, template: dict, prefix: str, dtype, dev
                  ) -> Tuple[list, list, set]:
    """Fill `template` (a zero tree on `dev`) from `sd`, leaf by leaf, by
    the published name (`prefix` + path); a missing or mis-shaped tensor
    counts as missed. Returns (loaded, missed, used keys)."""
    from flexam_tpu_torch.io.checkpoints import _source
    from flexam_tpu_torch.io.convert import leaf
    loaded, missed, used = [], [], set()
    for ours, tgt in flatten(template).items():
        key = prefix + torch_name(ours)
        tag = ours if not prefix else key
        if key not in sd:
            missed.append(tag)
            continue
        t = _source(sd, key)[0]
        if tuple(t.shape) != tuple(tgt.shape):
            missed.append(tag)
            continue
        set_path(template, ours, leaf(t, dev, dtype))
        loaded.append(tag)
        used.add(key)
    return loaded, missed, used


def svd_unet_params_from_state_dict(sd: Mapping, cfg: SVDUNetConfig,
                                    dtype=torch.float32, device="cuda"
                                    ) -> Tuple[dict, Dict[str, list]]:
    """Map a published-layout state dict onto the init tree, on `device`
    (kernels stay OIHW / OIDHW). Returns (params, coverage report)."""
    dev = resolve_device(device)
    params = _unet_tree(cfg, ParamDraw(None, dtype, dev))
    loaded, missed, used = load_by_names(sd, params, "", dtype, dev)
    unused = [k for k in sd if k not in used]
    return params, {"loaded": loaded, "missed": missed, "unused": unused}


def svd_unet_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """The inverse: the published naming (tensors as stored)."""
    return {torch_name(ours): v for ours, v in flatten(params).items()}


# ---------------------------------------------------------------------------
# EDM v-prediction sampling (the published scheduler semantics)
# ---------------------------------------------------------------------------

def karras_sigmas(n: int, sigma_min: float = 0.002,
                  sigma_max: float = 700.0, rho: float = 7.0) -> np.ndarray:
    """Karras et al. sigma schedule, high -> low, with a trailing 0."""
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    mn, mx = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    sig = (mx + ramp * (mn - mx)) ** rho
    return np.concatenate([sig, [0.0]]).astype(np.float32)


def euler_v_step(sample: torch.Tensor, v: torch.Tensor, sigma,
                 sigma_next) -> torch.Tensor:
    """One Euler step under v-prediction (the model sees
    sample / sqrt(sigma^2 + 1)); the scalars in float32, as JAX's."""
    sigma, sigma_next = np.float32(sigma), np.float32(sigma_next)
    denom = sigma ** np.float32(2) + np.float32(1)
    x0 = v * float(-sigma / np.sqrt(denom)) + sample / float(denom)
    d = (sample - x0) / float(sigma)
    return sample + d * float(sigma_next - sigma)

