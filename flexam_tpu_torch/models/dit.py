"""Wan2.2 FlexAM DiT in PyTorch.

Port of `flexam_tpu/models/dit.py` (`dit_forward` and what it calls):
patch embedding, the Control-Camera adapter (`_camera_adapter`, added to
the patch tokens when the config has `add_control_adapter` and a folded
camera video comes in as `y_camera`), the reference-frame token prepend,
the 5-conv control fusion CNN, time and density embeddings (fp32), scalar
and binary timesteps, the block stack (a Python loop over per-block
parameter dicts) and the head + unpatchify.

On the kernel path (head_dim % 128 == 0, the dispatch by shape of the JAX
`_use_fused`) the q/k RMSNorm + RoPE runs as kernel B3 and the two
LayerNorm + AdaLN prologues of a block as kernel B4; attention goes through
`core.attention` (B1/B2 on CUDA), in the compute dtype, bf16 or fp32
(`compute_dtype=torch.float32`: the fp32 kernels, B1/B2 on TF32), as JAX's
`_use_fused` checks only the head dim. On a CPU tensor every kernel takes
its plain version. `attn_fn` replaces the attention of every block (the
pipeline passes B5's sparse closure there); RIFLEx comes in through the
RoPE tables (`make_rope_tables_for(..., riflex=)`).
`dit_forward_teacache` is the TeaCache forward; as JAX's, it takes no
`y_camera`.

Parameters are the JAX tree with `blocks` as a list of per-block dicts
(`io.convert.from_jax_params` maps a JAX tree, `init_dit_params` makes a
random one on the device).

Under `parallel.activation_sharding(mesh)` (JAX's token constraint at
`_dit_prepare`'s end, `models/dit.py:546`) every rank runs `_dit_prepare`
on the whole inputs, keeps its [B/dp, L/sp] share of the tokens and of
the per-token terms (e0, the binary-timestep mask, the RoPE tables at its
global token offset), runs the blocks on it with a mesh attention
(`parallel.ulysses.mesh_attention`: the given attn_fn becomes Ulysses'
inner unless it is a mesh attention already), runs the head, and gathers.
Block weights split by `parallel.dit_param_shardings` run as column- and
row-split linears over tp; q and k are gathered over tp before their
RMSNorm (over the whole hidden dim, B3's) and each rank keeps its heads.
Every rank returns the whole velocity.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from flexam_tpu_torch.config import DiTConfig
from flexam_tpu_torch.core.attention import attention
from flexam_tpu_torch.core.layers import (gelu_tanh, group_norm, layer_norm,
                                          linear, linear_init, rms_norm, silu,
                                          sinusoidal_embedding_1d)
from flexam_tpu_torch.core.rope import (apply_rope, build_video_rope,
                                        make_rope_tables)
from flexam_tpu_torch.device import resolve_device
from flexam_tpu_torch.ops.fused import ln_modulation, rmsnorm_rope
from flexam_tpu_torch.parallel import comm
from flexam_tpu_torch.parallel.sharding import (active_mesh, tp_heads,
                                                tp_row, token_layout)
from flexam_tpu_torch.parallel.ulysses import mesh_attention


def use_kernels(head_dim: int) -> bool:
    """The fused kernels B3/B4 serve head dims that are a multiple of 128,
    the head dims the attention kernels take on the card (128 on every
    preset, 256 and wider too); other head dims take the unfused
    composition. FLEXAM_FUSED, as JAX's `fused_enabled` reads it, turns them
    off when set to anything but 1 / interpret (FLEXAM_FUSED=0: the
    differentiable composition that training takes)."""
    env = os.environ.get("FLEXAM_FUSED")
    if env is not None and env not in ("1", "interpret"):
        return False
    return head_dim % 128 == 0


# ---------------------------------------------------------------------------
# Random parameters, made on the device
# ---------------------------------------------------------------------------

def _mlp2_init(gen, d_in, d_mid, d_out, **kw):
    return {"fc1": linear_init(gen, d_in, d_mid, **kw),
            "fc2": linear_init(gen, d_mid, d_out, **kw)}


def _attn_init(gen, dim, dtype, device):
    kw = dict(dtype=dtype, device=device)
    p = {n: linear_init(gen, dim, dim, **kw) for n in ("q", "k", "v", "o")}
    p["norm_q"] = torch.ones((dim,), **kw)
    p["norm_k"] = torch.ones((dim,), **kw)
    return p


def _modulation(gen, rows, dim, device):
    return torch.randn((1, rows, dim), generator=gen, device=device) \
        / dim ** 0.5


def _conv_init(gen, shape, dtype, device):
    fan_in = math.prod(shape[1:])
    limit = math.sqrt(6.0 / (fan_in + shape[0]))
    w = torch.empty(shape, dtype=dtype, device=device)
    w.uniform_(-limit, limit, generator=gen)
    return {"weight": w, "bias": torch.zeros((shape[0],), dtype=dtype,
                                             device=device)}


def init_dit_params(cfg: DiTConfig, seed: int = 0, dtype=torch.bfloat16,
                    device="cuda") -> dict:
    """Random parameters with the JAX init's distributions (xavier-uniform
    linears and convs, N(0, 1/dim) fp32 modulation tables), drawn on the
    device from a `torch.Generator` seeded with `seed`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(dtype=dtype, device=dev)
    dim = cfg.dim
    pt, ph, pw = cfg.patch_size
    params = {
        "patch_embedding": _conv_init(gen, (dim, cfg.in_dim, pt, ph, pw),
                                      dtype, dev),
        "text_embedding": _mlp2_init(gen, cfg.text_dim, dim, dim, **kw),
        "time_embedding": _mlp2_init(gen, cfg.freq_dim, dim, dim, **kw),
        "time_projection": {"fc": linear_init(gen, dim, dim * 6, **kw)},
        "density_embedding": _mlp2_init(gen, cfg.freq_dim, dim, dim, **kw),
        "density_projection": {"fc": linear_init(gen, dim, dim * 2, **kw)},
        "head": {
            "head": linear_init(gen, dim, math.prod(cfg.patch_size)
                                * cfg.out_dim, **kw),
            "modulation": _modulation(gen, 2, dim, dev),
            "modulation_density": _modulation(gen, 1, dim, dev),
        },
    }
    blocks = []
    for _ in range(cfg.num_layers):
        bp = {
            "self_attn": _attn_init(gen, dim, dtype, dev),
            "cross_attn": _attn_init(gen, dim, dtype, dev),
            "ffn": _mlp2_init(gen, dim, cfg.ffn_dim, dim, **kw),
            "modulation": _modulation(gen, 6, dim, dev),
            "modulation_density": _modulation(gen, 2, dim, dev),
        }
        if cfg.cross_attn_norm:
            bp["norm3"] = {"weight": torch.ones((dim,), **kw),
                           "bias": torch.zeros((dim,), **kw)}
        blocks.append(bp)
    params["blocks"] = blocks
    if cfg.add_ref_conv:
        params["ref_conv"] = _conv_init(gen, (dim, cfg.in_dim_ref_conv, ph, pw),
                                        dtype, dev)
    if cfg.add_control_adapter:
        cin = (cfg.in_dim_control_adapter
               * cfg.downscale_factor_control_adapter ** 2)
        params["control_adapter"] = {
            "conv": _conv_init(gen, (dim, cin, ph, pw), dtype, dev),
            "res_conv1": _conv_init(gen, (dim, dim, 3, 3), dtype, dev),
            "res_conv2": _conv_init(gen, (dim, dim, 3, 3), dtype, dev),
        }
    if cfg.add_cnn_block:
        c1, c2 = cfg.cnn_block_dims

        def gn(c):
            return {"weight": torch.ones((c,), **kw),
                    "bias": torch.zeros((c,), **kw)}

        params["cnn"] = {
            "conv1": _conv_init(gen, (c1, cfg.in_dim_cnn_block, 1, 3, 3),
                                dtype, dev),
            "gn1": gn(c1),
            "conv2": _conv_init(gen, (c1, c1, 1, 3, 3), dtype, dev),
            "gn2": gn(c1),
            "conv3": _conv_init(gen, (c2, c1, 1, 3, 3), dtype, dev),
            "gn3": gn(c2),
            "conv4": _conv_init(gen, (c2, c2, 1, 3, 3), dtype, dev),
            "gn4": gn(c2),
            "conv5": _conv_init(gen, (cfg.out_dim_cnn_block, c2, 1, 1, 1),
                                dtype, dev),
        }
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _patch_embed(x: torch.Tensor, p: dict, patch: Tuple[int, int, int]):
    """Conv3d(stride = kernel = patch) as rearrange + matmul.
    x [B, C, F, H, W] -> tokens [B, F'*H'*W', dim], grid (F', H', W')."""
    b, c, f, h, w = x.shape
    pt, ph, pw = patch
    fo, ho, wo = f // pt, h // ph, w // pw
    xt = x.reshape(b, c, fo, pt, ho, ph, wo, pw)
    xt = xt.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, fo * ho * wo, -1)
    wmat = p["weight"].reshape(p["weight"].shape[0], -1)
    out = torch.matmul(xt, wmat.to(xt.dtype).t()) + p["bias"].to(xt.dtype)
    return out, (fo, ho, wo)


def _ref_embed(ref: torch.Tensor, p: dict, patch_hw: Tuple[int, int]):
    """Conv2d(stride = kernel = (ph, pw)) for the reference-frame latent:
    ref [B, C, H, W] -> tokens [B, H'*W', dim]."""
    b, c, h, w = ref.shape
    ph, pw = patch_hw
    ho, wo = h // ph, w // pw
    xt = ref.reshape(b, c, ho, ph, wo, pw).permute(0, 2, 4, 1, 3, 5)
    xt = xt.reshape(b, ho * wo, -1)
    wmat = p["weight"].reshape(p["weight"].shape[0], -1)
    return torch.matmul(xt, wmat.to(xt.dtype).t()) + p["bias"].to(xt.dtype)


def _camera_adapter(p: dict, y_camera: torch.Tensor,
                    patch_hw: Tuple[int, int], downscale: int) -> torch.Tensor:
    """`SimpleAdapter` (`wan_camera_adapter.py:5-41`): PixelUnshuffle with
    channel order (c, dy, dx), a conv of stride = kernel = the patch to the
    patch grid, and one ReLU residual block of two 3x3 convs. y_camera
    [B, C, F, H, W] (the Plucker camera video folded 4 frames to channels)
    -> tokens [B, F*H'*W', dim]."""
    b, c, f, h, w = y_camera.shape
    d = downscale
    x = y_camera.transpose(1, 2).reshape(b * f, c, h // d, d, w // d, d)
    x = x.permute(0, 1, 3, 5, 2, 4).reshape(b * f, c * d * d, h // d, w // d)

    def conv(xx, pp, **kw):
        return F.conv2d(xx, pp["weight"].to(xx.dtype),
                        pp["bias"].to(xx.dtype), **kw)

    x = conv(x, p["conv"], stride=patch_hw)
    res = conv(torch.relu(conv(x, p["res_conv1"], padding=1)),
               p["res_conv2"], padding=1)
    x = x + res
    dim, hh, ww = x.shape[1:]
    return x.reshape(b, f, dim, hh * ww).transpose(2, 3).reshape(
        b, f * hh * ww, dim)


def _conv3d(x: torch.Tensor, p: dict, padding) -> torch.Tensor:
    return F.conv3d(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype),
                    padding=padding)


def _cnn_fusion(cnn: dict, x: torch.Tensor, groups: Tuple[int, int]):
    """The FlexAM control-fusion CNN: five convs (1x3x3 x4, 1x1x1), two
    residual hops. Channels-first [B, C, F, H, W] in and out."""
    g1, g2 = groups

    def step(h, conv, gn, g):
        h = _conv3d(h, cnn[conv], (0, 1, 1))
        return silu(group_norm(h, cnn[gn]["weight"], cnn[gn]["bias"], g))

    x1 = step(x, "conv1", "gn1", g1)
    x2 = step(x1, "conv2", "gn2", g1) + x1
    x3 = step(x2, "conv3", "gn3", g2)
    x4 = step(x3, "conv4", "gn4", g2) + x3
    return _conv3d(x4, cnn["conv5"], 0)


def _qk_norm(y, gamma, num_heads, eps, tp, rope=None):
    """RMSNorm over the whole hidden dim, and the 3D RoPE when `rope` =
    (cos, sin) is given (B3 on the kernel path): [B, S, H, dh]. Under tp
    (`tp` the mesh) y holds this rank's columns: it is gathered over tp
    first and this rank's heads are kept after."""
    if tp is not None:
        y = comm.gather(y, tp, "tp", -1)
    b, s, dim = y.shape
    d = dim // num_heads
    if rope is not None and use_kernels(d):
        out = rmsnorm_rope(y.contiguous(), gamma, rope[0], rope[1],
                           num_heads, eps)
    else:
        out = rms_norm(y, gamma, eps).reshape(b, s, num_heads, d)
        if rope is not None:
            out = apply_rope(out, rope[0], rope[1])
    if tp is not None:
        out = tp_heads(out, tp)
    return out


def _row(x, p, tp):
    """The output linear of a split: a row-split linear under tp."""
    return linear(x, p) if tp is None else tp_row(x, p, tp)


def _self_attention(p, x, cos, sin, num_heads, eps, attn_fn, tp=None):
    """q/k RMSNorm over the full dim, 3D RoPE, attention, output proj."""
    b, s, _ = x.shape
    d = x.shape[-1] // num_heads
    x = comm.copy_to(x, tp, "tp")
    q = _qk_norm(linear(x, p["q"]), p["norm_q"], num_heads, eps, tp,
                 (cos, sin))
    k = _qk_norm(linear(x, p["k"]), p["norm_k"], num_heads, eps, tp,
                 (cos, sin))
    v = linear(x, p["v"]).reshape(b, s, -1, d)
    out = attn_fn(q, k, v, k_len=None)
    return _row(out.reshape(b, s, -1), p["o"], tp)


def _cross_attention(p, x, context, num_heads, eps, attn_fn, tp=None):
    """Text cross-attention; all (zero-embedded pad) text tokens take part."""
    b, s, _ = x.shape
    d = x.shape[-1] // num_heads
    lk = context.shape[1]
    x = comm.copy_to(x, tp, "tp")
    context = comm.copy_to(context, tp, "tp")
    q = _qk_norm(linear(x, p["q"]), p["norm_q"], num_heads, eps, tp)
    k = _qk_norm(linear(context, p["k"]), p["norm_k"], num_heads, eps, tp)
    v = linear(context, p["v"]).reshape(b, lk, -1, d)
    out = attn_fn(q, k, v, k_len=None)
    return _row(out.reshape(b, s, -1), p["o"], tp)


def _block_forward(bp, x, e0, de0, cos, sin, context, cfg: DiTConfig,
                   attn_fn, cross_fn=None, tp=None):
    """One attention block.

    e0:  [B, Lm, 6, dim] fp32 (Lm in {1, L}) or the binary-timestep tuple
         ("binary", e0_pair [B, 2, 6, dim], mask [B, L])
    de0: [B, 1, 2, dim] fp32 density terms
    cross_fn: the cross-attention's attention (default attn_fn); tp: the
    mesh when the block's linears are split over tp
    """
    dtype = x.dtype
    mod = bp["modulation"].float()[None]                      # [1,1,6,dim]
    de = bp["modulation_density"].float()[None] + de0         # [B,1,2,dim]
    binary = isinstance(e0, tuple)
    if binary:
        _, pair, mask = e0
        e_pair = mod + pair                                   # [B,2,6,dim]
        m = mask[:, :, None]

        def term(i):
            ti = e_pair[:, :, i, :]
            return (ti[:, 0:1] * m + ti[:, 1:2] * (1 - m)).to(dtype)
    else:
        e = mod + e0                                          # [B,Lm,6,dim]

        def term(i):
            return e[:, :, i, :].to(dtype)

    def dterm(i):
        return de[:, :, i, :].to(dtype)

    # the two LN + AdaLN prologues run as kernel B4 (the density shift
    # folds into the shift term in fp32); the per-token general mode
    # (e0 [B, L, 6, dim]) keeps the unfused composition
    fuse_ln = use_kernels(cfg.dim // cfg.num_heads) and (
        binary or e0.shape[1] == 1)

    def prologue(i_shift, i_scale, i_density):
        if not fuse_ln:
            return (layer_norm(x, eps=1e-6) * (1.0 + term(i_scale))
                    + term(i_shift) + dterm(i_density)).to(dtype)
        if binary:
            sh = e_pair[:, :, i_shift] + de[:, :, i_density]   # [B,2,dim]
            return ln_modulation(x.contiguous(), sh, e_pair[:, :, i_scale],
                                 mask=e0[2])
        sh = e[:, 0, i_shift] + de[:, 0, i_density]            # [B,dim]
        return ln_modulation(x.contiguous(), sh, e[:, 0, i_scale])

    y = _self_attention(bp["self_attn"], prologue(0, 1, 0), cos, sin,
                        cfg.num_heads, cfg.eps, attn_fn, tp)
    x = x + y * term(2)
    xn = (layer_norm(x, bp["norm3"]["weight"], bp["norm3"]["bias"], eps=1e-6)
          if cfg.cross_attn_norm else x)
    x = x + _cross_attention(bp["cross_attn"], xn, context, cfg.num_heads,
                             cfg.eps, cross_fn or attn_fn, tp)
    tmp = comm.copy_to(prologue(3, 4, 1), tp, "tp")
    y = _row(gelu_tanh(linear(tmp, bp["ffn"]["fc1"])), bp["ffn"]["fc2"], tp)
    return x + y * term(5)


def _head_forward(hp, x, e, de):
    """Head: AdaLN with the time and density terms, then the projection.
    e: [B, dim] (scalar t) or [B, L, dim] (per-token t), fp32;
    de: [B, dim] fp32 density embedding."""
    dtype = x.dtype
    mod = hp["modulation"].float()                       # [1, 2, dim]
    if e.dim() == 2:
        em = mod + e[:, None, :]                         # [B, 2, dim]
        shift, scale = em[:, None, 0, :], em[:, None, 1, :]
    else:
        em = mod[None] + e[:, :, None, :]                # [B, L, 2, dim]
        shift, scale = em[:, :, 0, :], em[:, :, 1, :]
    dshift = hp["modulation_density"].float()[:, 0, :][None] + de[:, None, :]
    xn = (layer_norm(x, eps=1e-6) * (1.0 + scale.to(dtype))
          + shift.to(dtype) + dshift.to(dtype))
    return linear(xn.to(dtype), hp["head"])


def _unpatchify(x, grid, patch, out_dim):
    """[B, L, prod(patch)*c] -> [B, c, F, H, W]."""
    b = x.shape[0]
    f, h, w = grid
    pt, ph, pw = patch
    u = x[:, :f * h * w].reshape(b, f, h, w, pt, ph, pw, out_dim)
    u = u.permute(0, 7, 1, 4, 2, 5, 3, 6)                # b c f p h q w r
    return u.reshape(b, out_dim, f * pt, h * ph, w * pw)


def _f32(lin: dict) -> dict:
    return {k: v.float() for k, v in lin.items() if v is not None}


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rope_tables(head_dim: int, max_seq: int,
                 device: torch.device) -> torch.Tensor:
    """The default RoPE angle table on `device`, made once (no host copy a
    forward, so a training step can be captured in a CUDA graph)."""
    return torch.from_numpy(make_rope_tables(head_dim, max_seq)).to(device)


def _dit_prepare(params, cfg: DiTConfig, x, t, context, density, y,
                 additional_control, full_ref, rope_tables, y_camera,
                 binary_t_mask):
    """Everything before the block stack: tokens plus the per-step
    conditioning tensors."""
    compute_dtype = x.dtype
    _, ph, pw = cfg.patch_size

    if y is not None:
        if cfg.add_cnn_block and additional_control is not None:
            c_lat = x.shape[1]
            control, inpaint = y[:, :c_lat], y[:, c_lat:]
            cnn_out = _cnn_fusion(params["cnn"],
                                  torch.cat([control, additional_control], 1),
                                  cfg.cnn_block_groups)
            y = torch.cat([cnn_out, inpaint], dim=1)
        x = torch.cat([x, y], dim=1)

    tokens, grid = _patch_embed(x, params["patch_embedding"], cfg.patch_size)
    b = tokens.shape[0]
    f, gh, gw = grid

    if cfg.add_control_adapter and y_camera is not None:
        tokens = tokens + _camera_adapter(
            params["control_adapter"], y_camera.to(tokens.dtype), (ph, pw),
            cfg.downscale_factor_control_adapter)

    l_ref = 0
    if cfg.add_ref_conv and full_ref is not None:
        ref_tok = _ref_embed(full_ref, params["ref_conv"], (ph, pw))
        l_ref = ref_tok.shape[1]
        tokens = torch.cat([ref_tok, tokens], dim=1)
        grid = (f + 1, gh, gw)
        if t.dim() == 2:
            t = torch.cat([t[:, -1:].expand(b, l_ref), t], dim=1)
    seq_len = tokens.shape[1]

    if rope_tables is None:
        rope_tables = _rope_tables(cfg.head_dim, cfg.rope_max_seq, x.device)
    cos, sin = build_video_rope(rope_tables, grid, cfg.head_dim)

    def time_mlp(pos):
        emb = sinusoidal_embedding_1d(cfg.freq_dim, pos)
        h1 = silu(linear(emb, _f32(params["time_embedding"]["fc1"])))
        return linear(h1, _f32(params["time_embedding"]["fc2"]))

    proj = _f32(params["time_projection"]["fc"])
    if binary_t_mask is not None:
        # the TI2V per-token pattern has two values, t on generated tokens
        # and 0 on known ones: run the time MLP on the pair, select per token
        assert t.dim() == 1
        pair = torch.stack([t.float(), torch.zeros_like(t, dtype=torch.float32)],
                           dim=1)                              # [B, 2]
        e_pair = time_mlp(pair)                                # [B, 2, dim]
        e0_pair = linear(silu(e_pair), proj).reshape(b, 2, 6, cfg.dim)
        mask = binary_t_mask.float()
        if mask.shape[1] < seq_len:   # ref and tail tokens use t (mask 1)
            padn = seq_len - mask.shape[1]
            ones = mask.new_ones
            mask = (torch.cat([ones((b, l_ref)), mask,
                               ones((b, padn - l_ref))], dim=1)
                    if l_ref else torch.cat([mask, ones((b, padn))], dim=1))
        e0 = ("binary", e0_pair, mask)
        e_head = (e_pair[:, 0:1] * mask[:, :, None]
                  + e_pair[:, 1:2] * (1 - mask[:, :, None]))   # [B, L, dim]
    elif t.dim() == 2:                                         # per-token t
        if t.shape[1] < seq_len:
            t = torch.cat([t, t[:, -1:].expand(b, seq_len - t.shape[1])], 1)
        e = time_mlp(t.float())                                # [B, L, dim]
        e0 = linear(silu(e), proj).reshape(b, seq_len, 6, cfg.dim)
        e_head = e
    else:
        e = time_mlp(t.float())                                # [B, dim]
        e0 = linear(silu(e), proj).reshape(b, 1, 6, cfg.dim)
        e_head = e

    if density is not None:
        demb = sinusoidal_embedding_1d(cfg.freq_dim, density.float())
        de = linear(silu(linear(demb, _f32(params["density_embedding"]["fc1"]))),
                    _f32(params["density_embedding"]["fc2"]))
        de0 = linear(silu(de), _f32(params["density_projection"]["fc"]))
        de0 = de0.reshape(b, 1, 2, cfg.dim)
        de_head = de
    else:
        de0 = torch.zeros((b, 1, 2, cfg.dim), device=x.device)
        de_head = torch.zeros((b, cfg.dim), device=x.device)

    ctx = linear(context.to(compute_dtype), params["text_embedding"]["fc1"])
    ctx = linear(gelu_tanh(ctx), params["text_embedding"]["fc2"])
    return tokens, e0, de0, e_head, de_head, cos, sin, ctx, grid, l_ref


def dit_forward(
    params: dict,
    cfg: DiTConfig,
    x: torch.Tensor,                      # [B, C_lat, F, H, W] noisy latent
    t: torch.Tensor,                      # [B] or [B, L_video] timesteps
    context: torch.Tensor,                # [B, text_len, text_dim]
    density: Optional[torch.Tensor] = None,              # [B]
    y: Optional[torch.Tensor] = None,                    # [B, C_y, F, H, W]
    additional_control: Optional[torch.Tensor] = None,   # [B, C_ac, F, H, W]
    full_ref: Optional[torch.Tensor] = None,             # [B, C_lat, H, W]
    rope_tables: Optional[torch.Tensor] = None,          # [max_seq, dh//2]
    attn_fn: Callable = attention,
    y_camera: Optional[torch.Tensor] = None,             # [B, C*4, F, H, W]
    binary_t_mask: Optional[torch.Tensor] = None,        # [B, L_video]
) -> torch.Tensor:
    """Velocity prediction [B, out_dim, F, H, W]."""
    prep = _dit_prepare(params, cfg, x, t, context, density, y,
                        additional_control, full_ref, rope_tables, y_camera,
                        binary_t_mask)
    run = _Run(params, cfg, attn_fn, prep)
    return run.finish(run.blocks(run.tokens))


class _Run:
    """One forward's token stream: on one device as it is, under an active
    mesh each rank's share (see the module docstring)."""

    def __init__(self, params, cfg: DiTConfig, attn_fn, prep):
        (tokens, e0, de0, e_head, de_head, cos, sin, ctx, self.grid,
         self.l_ref) = prep
        self.params, self.cfg = params, cfg
        self.layout, self.tp = None, None
        self.self_fn = self.cross_fn = attn_fn
        mesh = active_mesh()
        if mesh is not None:
            attn = mesh_attention(mesh, attn_fn)
            b, seq = tokens.shape[:2]
            lay = token_layout(mesh, b, seq, attn.token_axes)
            self.layout = lay
            self.self_fn = attn if lay.token_axes else attn.inner
            self.cross_fn = attn.inner
            self.tp = mesh if _tp_split(params, cfg, mesh) else None
            tokens = lay.shard(tokens, 0, 1)
            if isinstance(e0, tuple):
                e0 = (e0[0], lay.shard(e0[1], 0), lay.shard(e0[2], 0, 1))
            else:
                e0 = lay.shard(e0, 0, 1 if e0.shape[1] > 1 else None)
            de0, de_head, ctx = (lay.shard(a, 0) for a in (de0, de_head, ctx))
            e_head = lay.shard(e_head, 0, 1 if e_head.dim() == 3 else None)
            if lay.token_axes:
                start, n = lay.token_range(seq)
                cos = _rope_rows(cos, start, n, 1.0)
                sin = _rope_rows(sin, start, n, 0.0)
        self.tokens, self.e0, self.de0, self.ctx = tokens, e0, de0, ctx
        self.e_head, self.de_head, self.cos, self.sin = e_head, de_head, cos, sin

    def blocks(self, tokens):
        return _dit_blocks(self.params, self.cfg, tokens, self.e0, self.de0,
                           self.cos, self.sin, self.ctx, self.self_fn,
                           self.cross_fn, self.tp)

    def finish(self, tokens):
        """Head (on this rank's share), the gather, the ref tokens
        stripped, unpatchify."""
        tokens = _head_forward(self.params["head"], tokens, self.e_head,
                               self.de_head)
        if self.layout is not None:
            tokens = self.layout.gather(tokens, 0, 1)
        grid = self.grid
        if self.l_ref:
            tokens = tokens[:, self.l_ref:]
            grid = (grid[0] - 1, grid[1], grid[2])
        return _unpatchify(tokens, grid, self.cfg.patch_size, self.cfg.out_dim)


def _dit_blocks(params, cfg, tokens, e0, de0, cos, sin, ctx, attn_fn,
                cross_fn=None, tp=None):
    for bp in params["blocks"]:
        tokens = _block_forward(bp, tokens, e0, de0, cos, sin, ctx, cfg,
                                attn_fn, cross_fn, tp)
    return tokens


def _rope_rows(table: torch.Tensor, start: int, n: int,
               identity: float) -> torch.Tensor:
    """The RoPE table's rows of the tokens [start, start + n): positions
    past the table pass unrotated, as in the whole stream (where none of
    them is in the table, one row of the identity rotation: cos 1, sin 0)."""
    rows = table[start:start + n]
    if rows.shape[0] == 0:
        rows = table.new_full((1, table.shape[1]), identity)
    return rows


def _out_rows(lin: dict) -> int:
    w = lin.get("weight_q", lin.get("weight"))
    return w.shape[0]


def _tp_split(params, cfg: DiTConfig, mesh) -> bool:
    """Whether the block linears hold this rank's tp slice (a tree through
    `dit_param_shardings` + `shard_pytree`) rather than the whole weight."""
    tp = mesh.shape.get("tp", 1)
    if tp == 1 or not params["blocks"]:
        return False
    if _out_rows(params["blocks"][0]["self_attn"]["q"]) == cfg.dim:
        return False
    if cfg.num_heads % tp:
        raise ValueError(f"{cfg.num_heads} heads do not split over tp={tp}")
    return True


# ---------------------------------------------------------------------------
# TeaCache
# ---------------------------------------------------------------------------

def init_teacache_state(batch: int, seq_len: int, dim: int,
                        dtype=torch.bfloat16, device="cuda") -> dict:
    """TeaCache state carried across steps (`FlexAM/models/cache_utils.py
    :21-77`); `computed` counts the forwards that ran the blocks."""
    dev = resolve_device(device)
    return {
        "prev_mod": torch.zeros((batch, 6, dim), device=dev),
        "accum": torch.zeros((), device=dev),
        "residual": torch.zeros((batch, seq_len, dim), dtype=dtype, device=dev),
        "computed": torch.zeros((), device=dev),
    }


# Fitted rescale polynomials per model family
# (`cache_utils.py:get_teacache_coefficients`)
TEACACHE_COEFFICIENTS = {
    "wan2.1-1.3b": (-5.21862437e+04, 9.23041404e+03, -5.28275948e+02,
                    1.36987616e+01, -4.99875664e-02),
    "wan2.1-t2v-14b": (-3.03318725e+05, 4.90537029e+04, -2.65530556e+03,
                       5.87365115e+01, -3.15583525e-01),
    "wan2.1-i2v-14b-480p": (2.57151496e+05, -3.54229917e+04, 1.40286849e+03,
                            -1.35890334e+01, 1.32517977e-01),
    "wan2.2": (8.10705460e+03, 2.13393892e+03, -3.72934672e+02,
               1.66203073e+01, -4.17769401e-02),
}


def get_teacache_coefficients(model_name: str):
    """Model-name keyed lookup (`cache_utils.py:4-18`)."""
    n = model_name.lower()
    if any(k in n for k in ("wan2.1-t2v-1.3b", "wan2.1-fun-1.3b",
                            "wan2.1-fun-v1.1-1.3b", "wan2.1-vace-1.3b")):
        return TEACACHE_COEFFICIENTS["wan2.1-1.3b"]
    if "wan2.1-t2v-14b" in n:
        return TEACACHE_COEFFICIENTS["wan2.1-t2v-14b"]
    if "wan2.1-i2v-14b-480p" in n:
        return TEACACHE_COEFFICIENTS["wan2.1-i2v-14b-480p"]
    if any(k in n for k in ("wan2.1-i2v-14b-720p", "wan2.1-fun-14b", "wan2.2",
                            "wan2.1-vace-14b")):
        return TEACACHE_COEFFICIENTS["wan2.2"]
    print(f"The model {model_name} is not supported by TeaCache.")
    return None


WAN22_TEACACHE_COEFFICIENTS = TEACACHE_COEFFICIENTS["wan2.2"]


def _polyval(coefficients: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Horner's rule, highest power first (`jnp.polyval`)."""
    out = torch.zeros_like(x)
    for c in coefficients:
        out = out * x + c
    return out


def dit_forward_teacache(
    params: dict,
    cfg: DiTConfig,
    x: torch.Tensor,
    t: torch.Tensor,
    context: torch.Tensor,
    tea_state: dict,
    step_index: int,
    density: Optional[torch.Tensor] = None,
    y: Optional[torch.Tensor] = None,
    additional_control: Optional[torch.Tensor] = None,
    full_ref: Optional[torch.Tensor] = None,
    rope_tables: Optional[torch.Tensor] = None,
    attn_fn: Callable = attention,
    coefficients=WAN22_TEACACHE_COEFFICIENTS,
    rel_l1_thresh: float = 0.10,
    num_skip_start_steps: int = 5,
    binary_t_mask: Optional[torch.Tensor] = None,
):
    """TeaCache forward (`wan_transformer3d_FlexAM.py:977-1008,1048-1051`):
    the polynomial-rescaled relative L1 change of the modulated input
    accumulates across steps; below the threshold the block stack is
    skipped and the cached residual added instead. JAX decides with
    `lax.cond` on the device; here the decision is one scalar read on the
    host a step (one sync), so that a skipped step launches no block.

    Under a mesh every rank decides alike with no collective: each rank
    runs `_dit_prepare` on the whole inputs, so it holds the whole e0 and
    reads the same scalar as one device (ranks that decided differently
    would wait on each other's collectives for ever). The cached residual
    is this rank's token share.

    Returns (velocity, new_tea_state)."""
    prep = _dit_prepare(params, cfg, x, t, context, density, y,
                        additional_control, full_ref, rope_tables, None,
                        binary_t_mask)
    e0 = prep[1]
    # the modulated input: e0 (scalar t) or the last token's (per-token t);
    # the last token is always a t-valued one, so in binary mode it is the
    # pair's t branch
    mod = (e0[1][:, 0] if isinstance(e0, tuple) else e0[:, -1]).float()
    prev_mod = tea_state["prev_mod"]
    run = _Run(params, cfg, attn_fn, prep)
    lay = run.layout
    rel = (mod - prev_mod).abs().mean() / (prev_mod.abs().mean() + 1e-12)
    coeffs = torch.as_tensor(coefficients, dtype=torch.float32,
                             device=rel.device)
    accum = tea_state["accum"] + _polyval(coeffs, rel)
    should_calc = (step_index < num_skip_start_steps
                   or bool((accum >= rel_l1_thresh).item()))
    tokens = run.tokens
    if should_calc:
        accum = torch.zeros_like(accum)
        out = run.blocks(tokens)
        residual = out - tokens
        tokens = out
    else:
        residual = tea_state["residual"]
        if lay is not None and residual.shape != tokens.shape:
            residual = lay.shard(residual, 0, 1)
        tokens = tokens + residual.to(tokens.dtype)
    new_state = {
        "prev_mod": mod,
        "accum": accum,
        "residual": residual.to(tea_state["residual"].dtype),
        "computed": tea_state["computed"] + float(should_calc),
    }
    return run.finish(tokens), new_state


def make_rope_tables_for(cfg: DiTConfig, device="cpu",
                         riflex: Optional[dict] = None) -> torch.Tensor:
    """RoPE angle table [rope_max_seq, head_dim//2] fp32 for a config, with
    the RIFLEx temporal part when `riflex` is given."""
    return torch.from_numpy(make_rope_tables(cfg.head_dim, cfg.rope_max_seq,
                                             riflex=riflex)).to(device)
