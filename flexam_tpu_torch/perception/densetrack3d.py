"""DELTA DenseTrack3D: the dense 3D point tracker.

Port of `flexam_tpu/perception/densetrack3d.py`, the same model in torch
ops on the caller's device (CUDA unless the caller asks for the CPU). The
call surface is the reference's (`pipelines.py:1374-1494`):

    model = DenseTrack3D(stride=4, window_len=16, add_space_attn=True,
                         num_virtual_tracks=64, model_resolution=(384, 512),
                         upsample_factor=4)
    out = DensePredictor3D(model)(video [B,T,3,H,W] 0..1,
                                  videodepth [B,T,1,H,W],
                                  grid_query_frame=0)
    out: {"trajs_uv": [B,T,N,2] input-pixel coords,
          "vis":      [B,T,N]   visibility in 0..1,
          "trajs_depth": [B,T,N,1] metric depth,
          "dense_reso": (h, w) of the dense output grid}

with torch tensors on the model's device in `out`. The JAX package's
design (its docstring says why): a CNN encoder at `stride`, every grid
cell of a window's first frame a query track plus learned virtual tracks,
`iters` transformer updates per sliding window from multi-scale local
correlation (diagonal shifted-product volumes on the regular grid), flow
and depth embeddings, tracks chained across windows, and a convex
upsampler to `model_resolution`.

Layouts: activations channels-last as in JAX ([N, H, W, C]); conv weights
in torch's [O, I, kh, kw] (`io/convert.py` turns JAX's HWIO kernels into
it), convolved through a channels-first view of the activations, with
JAX's "SAME" padding (asymmetric at stride 2). Attention goes through
`core.attention.exact_attention`, the counterpart of JAX's
`xla_attention` (head dim 48: no kernel takes it). The transformer's GELU
is JAX's default tanh form.

The windows' early exit is decided on the host after every
`iters_per_launch` iterations, as JAX decides it after each launch: where
the check falls changes the output. `model.last_info` records the windows
and the ones that exited early.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flexam_tpu_torch.core.attention import exact_attention
from flexam_tpu_torch.core.layers import layer_norm, linear, linear_init
from flexam_tpu_torch.core.resize import bilinear_gather, edge_pad, resize
from flexam_tpu_torch.device import resolve_device

# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DenseTrack3DConfig:
    """Constructor surface of the reference model (`pipelines.py:1374-1381`)
    plus the internals the (absent) source fixes."""
    stride: int = 4
    window_len: int = 16
    add_space_attn: bool = True
    num_virtual_tracks: int = 64
    model_resolution: Tuple[int, int] = (384, 512)   # (H, W)
    upsample_factor: int = 4
    # internals
    latent_dim: int = 128          # feature-encoder output channels
    dim: int = 384                 # update-transformer width
    num_heads: int = 8
    num_blocks: int = 6            # temporal attention blocks
    iters: int = 4                 # refinement iterations per window
    corr_levels: int = 4           # feature-pyramid levels
    corr_radius: int = 3           # sample radius r (7x7 taps per level)
    corr_volume_radius: int = 6    # volume half-extent R_v (13x13 cells)
    flow_bands: int = 10           # sincos bands for the flow embedding
    depth_bands: int = 8
    compute: str = "float32"       # transformer/encoder compute dtype
    iters_per_launch: int = 2      # iterations between early-exit checks
    # convergence early exit: a window whose last iteration group moved
    # tracks less than `early_exit_tol` coarse cells on average skips its
    # remaining iterations (one scalar read on the host per group)
    early_exit: bool = True
    early_exit_tol: float = 0.05

    @property
    def grid_hw(self) -> Tuple[int, int]:
        return (self.model_resolution[0] // self.stride,
                self.model_resolution[1] // self.stride)

    @property
    def dense_reso(self) -> Tuple[int, int]:
        return (self.grid_hw[0] * self.upsample_factor,
                self.grid_hw[1] * self.upsample_factor)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute == "bfloat16" else torch.float32

    @property
    def token_dim(self) -> int:
        corr = self.corr_levels * (2 * self.corr_radius + 1) ** 2
        flow = 4 * self.flow_bands + 2
        depth = 2 * (2 * self.depth_bands + 1)
        return corr + flow + depth + self.latent_dim + 1

    def validate(self):
        h, w = self.grid_hw
        div = 2 ** (self.corr_levels - 1)
        if h % div or w % div:
            raise ValueError(
                f"grid {h}x{w} must divide 2^(corr_levels-1)={div} "
                f"(model_resolution multiple of {self.stride * div})")
        if self.window_len % 2:
            raise ValueError("window_len must be even")


# ---------------------------------------------------------------------------
# small numerics helpers
# ---------------------------------------------------------------------------


def _sincos(x: torch.Tensor, bands: int) -> torch.Tensor:
    """[..., C] -> [..., C * 2 * bands] with frequencies 2^0..2^(bands-1)."""
    freqs = torch.tensor([2.0 ** i for i in range(bands)], dtype=x.dtype,
                         device=x.device)
    ang = x[..., None] * freqs                      # [..., C, bands]
    out = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return out.reshape(*x.shape[:-1], -1)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu` (approximate=True, its default), in its own order."""
    c = math.sqrt(2.0 / math.pi)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x.pow(3)))))


def bilinear_sample(field: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Sample `field` [H, W, C] (or [H, W]) at `pts` [..., 2] = (x, y) in
    cell coordinates (integer value = cell center), edge-clamped."""
    squeeze = field.dim() == 2
    if squeeze:
        field = field[..., None]
    out = bilinear_gather(field[None], pts[None, ..., 0], pts[None, ..., 1])[0]
    return out[..., 0] if squeeze else out


def _sample_frames(fields: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """fields [T, H, W] (or [T, H, W, C]) at pts [T, ..., 2], frame by
    frame (JAX's `vmap(bilinear_sample)`)."""
    squeeze = fields.dim() == 3
    if squeeze:
        fields = fields[..., None]
    out = bilinear_gather(fields, pts[..., 0], pts[..., 1])
    return out[..., 0] if squeeze else out


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one axis: (low, high)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv2d(x: torch.Tensor, p: dict, stride: int = 1) -> torch.Tensor:
    """NHWC conv with a torch-layout weight [O, I, kh, kw], SAME padding."""
    w = p["weight"].to(x.dtype)
    kh, kw = w.shape[2:]
    ph = _same_pads(x.shape[1], kh, stride)
    pw = _same_pads(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv2d(xc, w, stride=stride, padding=(ph[0], pw[0]))
    else:
        y = F.conv2d(F.pad(xc, (pw[0], pw[1], ph[0], ph[1])), w,
                     stride=stride)
    y = y.permute(0, 2, 3, 1)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def _conv_init(gen, kh, kw, cin, cout, device) -> dict:
    fan = kh * kw * cin
    w = torch.randn((cout, cin, kh, kw), generator=gen, device=device)
    return {"weight": w * math.sqrt(2.0 / fan),
            "bias": torch.zeros((cout,), device=device)}


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free instance norm over spatial dims of [N, H, W, C]."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mean).pow(2).mean(dim=(1, 2), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# feature encoder (RAFT/CoTracker BasicEncoder family, stride 4)
# ---------------------------------------------------------------------------


def _res_init(gen, cin, cout, device) -> dict:
    p = {"conv1": _conv_init(gen, 3, 3, cin, cout, device),
         "conv2": _conv_init(gen, 3, 3, cout, cout, device)}
    if cin != cout:
        p["skip"] = _conv_init(gen, 1, 1, cin, cout, device)
    return p


def encoder_init(gen, cfg: DenseTrack3DConfig, device) -> dict:
    c1, c2, c3 = 64, 96, cfg.latent_dim
    return {"stem": _conv_init(gen, 7, 7, 3, c1, device),
            "res1": [_res_init(gen, c1, c1, device),
                     _res_init(gen, c1, c1, device)],
            "res2": [_res_init(gen, c1, c2, device),
                     _res_init(gen, c2, c2, device)],
            "res3": [_res_init(gen, c2, c3, device),
                     _res_init(gen, c3, c3, device)],
            "out": _conv_init(gen, 1, 1, c3, cfg.latent_dim, device)}


def _res_block(p: dict, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    h = F.relu(_instance_norm(_conv2d(x, p["conv1"], stride)))
    h = F.relu(_instance_norm(_conv2d(h, p["conv2"])))
    if "skip" in p:
        x = _conv2d(x, p["skip"], stride)
    elif stride != 1:
        x = x[:, ::stride, ::stride]
    return x + h


def encode_frames(p: dict, frames: torch.Tensor,
                  chunk: int = 32) -> torch.Tensor:
    """frames [N, H, W, 3] (normalized) -> fmap [N, H/stride, W/stride, C],
    `chunk` frames at a time (every op is per frame)."""
    outs = []
    for i in range(0, frames.shape[0], chunk):
        x = F.relu(_instance_norm(_conv2d(frames[i:i + chunk], p["stem"],
                                          2)))
        x = _res_block(p["res1"][0], x)
        x = _res_block(p["res1"][1], x)
        x = _res_block(p["res2"][0], x, stride=2)
        x = _res_block(p["res2"][1], x)
        x = _res_block(p["res3"][0], x)
        x = _res_block(p["res3"][1], x)
        outs.append(_conv2d(x, p["out"]))
    return torch.cat(outs)


# ---------------------------------------------------------------------------
# correlation: diagonal shifted-product volumes on the regular grid
# ---------------------------------------------------------------------------


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean over axes 1, 2 of [T, h, w, C], odd sizes truncated
    (`lax.reduce_window` VALID sum * 0.25)."""
    t, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, : 2 * h2, : 2 * w2]
    return x.reshape(t, h2, 2, w2, 2, c).sum(dim=(2, 4)) * 0.25


def _edge_pad_hw(x: torch.Tensor, pad: int) -> torch.Tensor:
    """`jnp.pad(mode="edge")` by `pad` on axes 1, 2 of [T, h, w, C]."""
    return edge_pad(edge_pad(x, pad, 1), pad, 2)


def build_corr_volumes(f0: torch.Tensor, fmaps: torch.Tensor,
                       cfg: DenseTrack3DConfig) -> list:
    """f0 [h, w, C] (window's query-frame features), fmaps [Tw, h, w, C].

    Returns per level l a volume [Tw, h, w, S, S] with
    V[t, y, x, sy, sx] = <f0[y, x], pool_l(fmaps)[t, y + sy*2^l, x + sx*2^l]>
    (shift indices centered: s in [-R_v, R_v]), one multiply-reduce a
    shift, accumulated in fp32 whatever the fmap dtype."""
    tw, h, w, c = fmaps.shape
    rv = cfg.corr_volume_radius
    s_side = 2 * rv + 1
    scale = 1.0 / math.sqrt(c)
    f0f = f0.float()
    vols = []
    cur = fmaps
    for lvl in range(cfg.corr_levels):
        if lvl > 0:
            cur = _pool2(cur)
        step = 2 ** lvl
        # nearest-upsample back to the level-0 grid so a shift of one
        # level-l cell is a shift of `step` level-0 cells
        up = cur.repeat_interleave(step, dim=1).repeat_interleave(step,
                                                                  dim=2)
        pad = rv * step
        upp = _edge_pad_hw(up, pad)
        vol = torch.empty((tw, h, w, s_side * s_side), dtype=torch.float32,
                          device=fmaps.device)
        for i, sy in enumerate(range(-rv, rv + 1)):
            for j, sx in enumerate(range(-rv, rv + 1)):
                y0, x0 = pad + sy * step, pad + sx * step
                sl = upp[:, y0:y0 + h, x0:x0 + w]
                vol[..., i * s_side + j] = (sl.float() * f0f).sum(-1) * scale
        vols.append(vol.reshape(tw, h, w, s_side, s_side))
    return vols


def sample_corr(vols: list, disp: torch.Tensor,
                cfg: DenseTrack3DConfig) -> torch.Tensor:
    """disp [Tw, h, w, 2] = (dx, dy) offset from own grid cell, in level-0
    cells. Returns [Tw, h, w, corr_levels * (2r+1)^2]: each track reads a
    (2r+1)^2 neighborhood around its current offset by bilinear
    interpolation inside its own volume slice."""
    r = cfg.corr_radius
    rv = cfg.corr_volume_radius
    s_side = 2 * rv + 1
    taps = torch.tensor([(dy, dx) for dy in range(-r, r + 1)
                         for dx in range(-r, r + 1)], dtype=torch.float32,
                        device=disp.device)
    outs = []
    for lvl, vol in enumerate(vols):
        d = disp / (2.0 ** lvl)                          # level-l cells
        sx = (d[..., 0:1] + taps[:, 1] + rv).clamp(0.0, s_side - 1.0)
        sy = (d[..., 1:2] + taps[:, 0] + rv).clamp(0.0, s_side - 1.0)
        x0 = torch.floor(sx).clamp(0, s_side - 2)
        y0 = torch.floor(sy).clamp(0, s_side - 2)
        fx = sx - x0
        fy = sy - y0
        x0 = x0.long()
        y0 = y0.long()
        vflat = vol.reshape(*vol.shape[:3], -1)          # [Tw,h,w,S*S]

        def g(yy, xx):
            return torch.gather(vflat, -1, yy * s_side + xx)

        outs.append(g(y0, x0) * (1 - fx) * (1 - fy)
                    + g(y0, x0 + 1) * fx * (1 - fy)
                    + g(y0 + 1, x0) * (1 - fx) * fy
                    + g(y0 + 1, x0 + 1) * fx * fy)
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# update transformer
# ---------------------------------------------------------------------------


def _attn_block_init(gen, d: int, device) -> dict:
    ones = torch.ones((d,), device=device)
    zeros = torch.zeros((d,), device=device)
    return {
        "ln1_w": ones.clone(), "ln1_b": zeros.clone(),
        "lnkv_w": ones.clone(), "lnkv_b": zeros.clone(),
        "qkv": linear_init(gen, d, 3 * d, device=device),
        "proj": linear_init(gen, d, d, device=device, scale=0.02),
        "ln2_w": ones.clone(), "ln2_b": zeros.clone(),
        "fc1": linear_init(gen, d, 4 * d, device=device),
        "fc2": linear_init(gen, 4 * d, d, device=device, scale=0.02),
    }


def transformer_init(gen, cfg: DenseTrack3DConfig, device) -> dict:
    d = cfg.dim
    p = {
        "in_proj": linear_init(gen, cfg.token_dim, d, device=device),
        "time_embed": torch.randn((cfg.window_len, d), generator=gen,
                                  device=device) * 0.02,
        "virtual": torch.randn((cfg.num_virtual_tracks, d), generator=gen,
                               device=device) * 0.02,
        "head_delta": linear_init(gen, d, 4, device=device, scale=1e-3),
        "head_feat": linear_init(gen, d, cfg.latent_dim, device=device,
                                 scale=1e-3),
        "head_vis": linear_init(gen, d, 1, device=device),
        "time_blocks": [_attn_block_init(gen, d, device)
                        for _ in range(cfg.num_blocks)],
        "space_blocks": [],
    }
    n_space = cfg.num_blocks // 2 if cfg.add_space_attn else 0
    for _ in range(n_space):
        p["space_blocks"].append({
            "v_from_x": _attn_block_init(gen, d, device),
            "x_from_v": _attn_block_init(gen, d, device),
        })
    return p


def _mha(bp: dict, xq: torch.Tensor, xkv: Optional[torch.Tensor],
         heads: int) -> torch.Tensor:
    """Pre-norm residual attention; xq [B, Lq, D], xkv [B, Lk, D] or None
    for self-attention (JAX's `xkv is xq`: the keys share the query's
    norm)."""
    b, lq, d = xq.shape
    hq = layer_norm(xq, bp["ln1_w"], bp["ln1_b"])
    hkv = hq if xkv is None else layer_norm(xkv, bp["lnkv_w"],
                                            bp["lnkv_b"])
    lk = hkv.shape[1]
    dh = d // heads
    wq, wk, wv = torch.chunk(bp["qkv"]["weight"], 3, dim=0)
    bq, bk, bv = torch.chunk(bp["qkv"]["bias"], 3, dim=0)
    dt = hq.dtype
    q = hq @ wq.to(dt).t() + bq.to(dt)
    k = hkv @ wk.to(dt).t() + bk.to(dt)
    v = hkv @ wv.to(dt).t() + bv.to(dt)
    o = exact_attention(q.reshape(b, lq, heads, dh),
                        k.reshape(b, lk, heads, dh),
                        v.reshape(b, lk, heads, dh)).reshape(b, lq, d)
    x = xq + linear(o, bp["proj"])
    h = layer_norm(x, bp["ln2_w"], bp["ln2_b"])
    return x + linear(_gelu_tanh(linear(h, bp["fc1"])), bp["fc2"])


def run_transformer(p: dict, tokens: torch.Tensor,
                    cfg: DenseTrack3DConfig) -> torch.Tensor:
    """tokens [Tw, N, token_dim] -> refined features [Tw, N, dim]."""
    tw = tokens.shape[0]
    x = linear(tokens.to(cfg.dtype), p["in_proj"])
    te = p["time_embed"][:tw, None, :].to(x.dtype)
    x = x + te
    virt = p["virtual"][None].to(x.dtype).expand(
        tw, cfg.num_virtual_tracks, cfg.dim) + te
    si = 0
    for i, tb in enumerate(p["time_blocks"]):
        # temporal attention: each track attends over the window
        xt = x.transpose(0, 1)                     # [N, Tw, D]
        x = _mha(tb, xt, None, cfg.num_heads).transpose(0, 1)
        if cfg.add_space_attn and i % 2 == 1 and si < len(p["space_blocks"]):
            sb = p["space_blocks"][si]
            si += 1
            # virtual tokens summarize all tracks (per frame), then
            # broadcast global context back: O(N*K) instead of O(N^2)
            virt = _mha(sb["v_from_x"], virt, x, cfg.num_heads)
            x = _mha(sb["x_from_v"], x, virt, cfg.num_heads)
    return x


# ---------------------------------------------------------------------------
# convex upsampler (weights from the query frame only)
# ---------------------------------------------------------------------------


def upsampler_init(gen, cfg: DenseTrack3DConfig, device) -> dict:
    k2 = cfg.upsample_factor ** 2
    return {"conv1": _conv_init(gen, 3, 3, cfg.latent_dim, 128, device),
            "conv2": _conv_init(gen, 1, 1, 128, 9 * k2, device)}


def upsample_weights(p: dict, f0: torch.Tensor,
                     cfg: DenseTrack3DConfig) -> torch.Tensor:
    """f0 [h, w, C] -> convex weights [h, w, 9, k, k] (softmax over 9)."""
    h, w, _ = f0.shape
    k = cfg.upsample_factor
    m = _conv2d(F.relu(_conv2d(f0[None], p["conv1"])), p["conv2"])[0]
    return torch.softmax(m.reshape(h, w, 9, k, k).float(), dim=2)


def _neighborhoods(field: torch.Tensor) -> torch.Tensor:
    """field [..., h, w, F] -> [..., h, w, 9, F], each cell's edge-padded
    3x3 neighborhood in (dy, dx) row-major order."""
    h, w = field.shape[-3:-1]
    lead = field.shape[:-3]
    f2 = field.reshape(-1, h, w, field.shape[-1])
    fp = _edge_pad_hw(f2, 1)
    nb = torch.stack([fp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dim=3)
    return nb.reshape(*lead, h, w, 9, field.shape[-1])


def convex_upsample(field: torch.Tensor, weights: torch.Tensor,
                    k: int) -> torch.Tensor:
    """field [h, w, F] (or [T, h, w, F]), weights [h, w, 9, k, k] ->
    [h*k, w*k, F] (or [T, ...]): each fine pixel is a convex combination of
    its coarse cell's 3x3 neighborhood (RAFT-style)."""
    nb = _neighborhoods(field.float())
    h, w, f = field.shape[-3:]
    up = torch.einsum("hwnab,...hwnf->...hawbf", weights, nb)
    return up.reshape(*field.shape[:-3], h * k, w * k, f)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def densetrack3d_init(gen, cfg: DenseTrack3DConfig, device="cuda") -> dict:
    device = resolve_device(device)
    cfg.validate()
    return {"encoder": encoder_init(gen, cfg, device),
            "transformer": transformer_init(gen, cfg, device),
            "upsampler": upsampler_init(gen, cfg, device),
            "feat_proj": linear_init(gen, cfg.latent_dim, cfg.latent_dim,
                                     device=device)}


def _grid(h: int, w: int, device) -> torch.Tensor:
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    return torch.stack([gx, gy], dim=-1)                   # [h, w, 2]


def _window_setup(params, fmaps_w, cfg: DenseTrack3DConfig):
    """Per-window precompute: correlation volumes and the initial track
    features from the window's first frame."""
    f0 = fmaps_w[0]
    vols = build_corr_volumes(f0, fmaps_w, cfg)
    return vols, linear(f0.float(), params["feat_proj"])


def _window_iters(params, vols, dgrid_w, state, cfg: DenseTrack3DConfig,
                  n_iters: int):
    """`n_iters` refinement iterations over one window; returns the state
    and the mean |position delta| of the last iteration in coarse cells
    (the early-exit signal)."""
    pos, logr, tfeat, _ = state
    tw, h, w = dgrid_w.shape
    c = cfg.latent_dim
    tp = params["transformer"]
    grid = _grid(h, w, pos.device)
    logd0 = dgrid_w[0]
    upd_mask = (torch.arange(tw, device=pos.device) > 0).float()[:, None,
                                                                  None]
    vis = torch.zeros((tw, h, w), device=pos.device)
    for _ in range(n_iters):
        disp = pos - grid[None]
        corr = sample_corr(vols, disp, cfg)                # [Tw,h,w,L*49]
        flow_emb = torch.cat([disp, _sincos(disp * 0.25, cfg.flow_bands)],
                             dim=-1)
        # scene log-depth under the current position, per frame
        dsamp = _sample_frames(dgrid_w, pos)
        dlog = (dsamp - logd0[None]) + logr
        demb = torch.cat(
            [dlog[..., None], _sincos(dlog[..., None], cfg.depth_bands),
             logr[..., None], _sincos(logr[..., None], cfg.depth_bands)],
            dim=-1)[..., :2 * (2 * cfg.depth_bands + 1)]
        tokens = torch.cat(
            [corr, flow_emb, demb, tfeat[None].expand(tw, h, w, c),
             torch.zeros((tw, h, w, 1), device=pos.device)],
            dim=-1).reshape(tw, h * w, cfg.token_dim)
        y = run_transformer(tp, tokens, cfg).reshape(tw, h, w, cfg.dim)
        delta = linear(y, tp["head_delta"]).float()
        pos = pos + delta[..., :2] * upd_mask[..., None]
        logr = logr + delta[..., 2] * upd_mask
        tfeat = tfeat + linear(y, tp["head_feat"]).float().mean(dim=0)
        vis = linear(y, tp["head_vis"]).float()[..., 0]
    return (pos, logr, tfeat, vis), delta[..., :2].abs().mean()


def _window_chain(wpos, wlogr, wvis, dgrid_w, cur_pos, cur_lr):
    """Advance the frame-0 grid tracks through this window by sampling its
    dense fields at their position at the window's first frame; also
    returns absolute log-depth for the chained frames."""
    tw, h, w = wlogr.shape
    pts = cur_pos[None].expand(tw, h, w, 2)
    opos = _sample_frames(wpos, pts)                       # [Tw, h, w, 2]
    olr = _sample_frames(wlogr, pts) + cur_lr[None]
    ovis = _sample_frames(wvis, pts)
    dsamp = _sample_frames(dgrid_w, opos)
    return opos, olr, ovis, dsamp + olr


def _window_starts(t: int, cfg: DenseTrack3DConfig) -> np.ndarray:
    wl, stp = cfg.window_len, cfg.window_len // 2
    starts = list(range(0, max(t - wl, 0) + 1, stp))
    if starts[-1] + wl < t:
        starts.append(t - wl)
    return np.asarray(starts, np.int32)


def _precompute(params, video, videodepth, cfg: DenseTrack3DConfig):
    frames = ((video.float() - 0.5) / 0.5).to(cfg.dtype)
    fmaps = encode_frames(params["encoder"], frames)       # [T, h, w, C]
    dlog = torch.log(torch.clamp(videodepth.float(), min=1e-4))
    t, hm, wm = dlog.shape
    s = cfg.stride
    h, w = hm // s, wm // s
    dgrid = dlog[:, : h * s, : w * s].reshape(t, h, s, w, s).sum(
        dim=(2, 4)) / float(s * s)                         # [T, h, w]
    return fmaps, dgrid


def dense_track(params: dict, video: torch.Tensor, videodepth: torch.Tensor,
                cfg: DenseTrack3DConfig, t_real: int = 0,
                info: Optional[dict] = None):
    """Core tracker at model resolution, over windows and iteration groups.

    video [T, Hm, Wm, 3] in 0..1; videodepth [T, Hm, Wm] metric.
    Returns coarse buffers over the frame-0 dense grid:
      pos  [T, h, w, 2] (x, y) level-0 cell coords
      logd [T, h, w]    absolute log-depth of each track
      vis  [T, h, w]    logits
    plus fmap0 [h, w, C] for the upsampler. `info`, if given, receives
    the window starts, the iterations each ran, the early exits and the
    deltas the checks read."""
    del t_real
    t = video.shape[0]
    h, w = cfg.grid_hw
    wl = cfg.window_len
    dev = video.device
    fmaps, dgrid = _precompute(params, video, videodepth, cfg)

    grid_dev = _grid(h, w, dev)
    pos_buf = grid_dev[None].repeat(t, 1, 1, 1)
    logd_buf = torch.zeros((t, h, w), device=dev)
    vis_buf = torch.full((t, h, w), 3.0, device=dev)
    logr_buf = torch.zeros((t, h, w), device=dev)

    ipl = max(1, int(cfg.iters_per_launch))
    starts = [int(s) for s in _window_starts(t, cfg)]
    iters_run, exits, deltas = [], [], []
    for s in starts:
        fm_w = fmaps[s:s + wl]
        dg_w = dgrid[s:s + wl]
        vols, tfeat0 = _window_setup(params, fm_w, cfg)
        state = (grid_dev[None].expand(wl, h, w, 2),
                 torch.zeros((wl, h, w), device=dev), tfeat0,
                 torch.zeros((wl, h, w), device=dev))
        done = 0
        while done < cfg.iters:
            k = min(ipl, cfg.iters - done)
            state, last_delta = _window_iters(params, vols, dg_w, state,
                                              cfg, k)
            done += k
            if cfg.early_exit and done < cfg.iters:
                deltas.append(float(last_delta))
                if deltas[-1] < cfg.early_exit_tol:
                    exits.append(s)
                    break             # converged: skip remaining iterations
        iters_run.append(done)
        del vols
        wpos, wlogr, _, wvis = state
        opos, olr, ovis, ologd = _window_chain(
            wpos, wlogr, wvis, dg_w, pos_buf[s].clone(),
            logr_buf[s].clone())
        pos_buf[s:s + wl] = opos
        logr_buf[s:s + wl] = olr
        vis_buf[s:s + wl] = ovis
        logd_buf[s:s + wl] = ologd
    if info is not None:
        info.update(window_starts=starts, iters=iters_run,
                    early_exit_windows=exits, checked_deltas=deltas)
    return pos_buf, logd_buf, vis_buf, fmaps[0].float()


def densify(params: dict, pos: torch.Tensor, logd: torch.Tensor,
            vis: torch.Tensor, cfg: DenseTrack3DConfig, fmap0: torch.Tensor,
            chunk: int = 16):
    """Lift coarse buffers to the dense output grid via convex upsampling,
    `chunk` frames at a time.

    Returns (uv [T, Hd*Wd, 2] model-res pixels, depth [T, Hd*Wd],
    vis [T, Hd*Wd] in 0..1) with Hd, Wd = cfg.dense_reso."""
    t, h, w, _ = pos.shape
    k = cfg.upsample_factor
    dev = pos.device
    weights = upsample_weights(params["upsampler"], fmap0, cfg)
    grid = _grid(h, w, dev)
    # upsample displacements (smooth), then re-add the fine pixel grid
    px_per_cell = float(cfg.stride)
    fine_scale = px_per_cell / k
    hd, wd = h * k, w * k
    fine = _grid(hd, wd, dev)
    fine = (fine + 0.5) * fine_scale - 0.5
    uvs, deps, viss = [], [], []
    for i in range(0, t, chunk):
        p, ld, v = pos[i:i + chunk], logd[i:i + chunk], vis[i:i + chunk]
        disp_px = (p - grid) * px_per_cell                 # [c, h, w, 2]
        field = torch.cat([disp_px, ld[..., None], v[..., None]], dim=-1)
        up = convex_upsample(field, weights, k)            # [c, hd, wd, 4]
        uvs.append((up[..., :2] + fine).reshape(-1, hd * wd, 2))
        deps.append(torch.exp(up[..., 2]).reshape(-1, hd * wd))
        viss.append(torch.sigmoid(up[..., 3]).reshape(-1, hd * wd))
    return torch.cat(uvs), torch.cat(deps), torch.cat(viss)


def _jax_leaves(tree, path=""):
    """(keystr path, leaf) in `jax.tree_util` flatten order: dict keys
    sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_leaves(tree[k], f"{path}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jax_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _replace_leaves(tree, new: dict, path=""):
    if isinstance(tree, dict):
        return {k: _replace_leaves(v, new, f"{path}['{k}']")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_replace_leaves(v, new, f"{path}[{i}]")
                for i, v in enumerate(tree)]
    return new[path]


def _is_conv(path: str, t: torch.Tensor) -> bool:
    """A conv kernel: a 4-dim `weight` leaf (the perception trees' other
    4-dim leaves, VGGT's special tokens, have one layout in both)."""
    return t.dim() == 4 and path.endswith("['weight']")


def _jax_shape(path: str, t: torch.Tensor) -> tuple:
    """A leaf's shape in the JAX tree: conv kernels are HWIO there."""
    s = tuple(t.shape)
    return (s[2], s[3], s[1], s[0]) if _is_conv(path, t) else s


class DenseTrack3D:
    """Reference-constructor-compatible wrapper holding config and params
    on `device`.

    `DenseTrack3D(stride=4, window_len=16, ...)` mirrors
    `pipelines.py:1374-1381`; weights start random (the reference loads
    `densetrack3d.pth` with strict=False — see `load_densetrack3d`)."""

    def __init__(self, stride=4, window_len=16, add_space_attn=True,
                 num_virtual_tracks=64, model_resolution=(384, 512),
                 upsample_factor=4, seed: int = 0,
                 compute: str = "bfloat16", device="cuda", **internals):
        # the JAX wrapper's production default is bf16; tests pin float32
        self.cfg = DenseTrack3DConfig(
            stride=stride, window_len=window_len,
            add_space_attn=add_space_attn,
            num_virtual_tracks=num_virtual_tracks,
            model_resolution=tuple(model_resolution),
            upsample_factor=upsample_factor, compute=compute, **internals)
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = densetrack3d_init(gen, self.cfg, self.device)
        self.load_report = None    # set by load_densetrack3d
        self.load_ok = False       # random init until a checkpoint maps
        self.last_info = {}        # windows of the last run

    def load_state_dict(self, state_dict, strict: bool = False):
        self.params, report = map_torch_state_dict(
            self.params, state_dict, strict=strict)
        return report

    def state_dict(self) -> dict:
        """The params as a torch state dict (conv kernels [O, I, kh, kw],
        linears [out, in]) in the order the loader maps them, so that
        `load_state_dict(model.state_dict())` restores every leaf."""
        return {f"tensor_{i}": t for i, (_, t) in
                enumerate(_jax_leaves(self.params))}


class DensePredictor3D:
    """`DensePredictor3D(model)(video, videodepth, grid_query_frame=0)` —
    the exact call surface of `pipelines.py:1390,1456-1460`."""

    def __init__(self, model: DenseTrack3D):
        self.model = model

    def to(self, *a, **k):     # torch-API shims, as JAX's
        return self

    def eval(self):
        return self

    def cuda(self):
        return self

    @torch.no_grad()
    def __call__(self, video, videodepth, grid_query_frame: int = 0,
                 downsample: Optional[int] = None):
        if grid_query_frame != 0:
            raise NotImplementedError(
                "grid_query_frame != 0 (the reference always passes 0: "
                "pipelines.py:1460, annotator/nodes.py:399)")
        cfg = self.model.cfg
        dev = self.model.device
        v = torch.as_tensor(np.asarray(video, np.float32), device=dev)
        d = torch.as_tensor(np.asarray(videodepth, np.float32), device=dev)
        if v.dim() != 5:
            raise ValueError("video must be [B, T, C, H, W]")
        b, t, _, h_in, w_in = v.shape
        if b != 1:
            raise NotImplementedError("batch 1 only (like the reference)")
        hm, wm = cfg.model_resolution
        # 0..1 input like the reference predictor call (no max() heuristic:
        # it would mis-scale near-black clips)
        frames = resize(v[0].permute(0, 2, 3, 1), (t, hm, wm, 3),
                        "bilinear")
        dep = resize(d.reshape(t, 1, *d.shape[-2:])[:, 0], (t, hm, wm),
                     "bilinear")
        del v, d

        t_pad = max(t, cfg.window_len)
        if t_pad > t:
            frames = torch.cat([frames, frames[-1:].expand(t_pad - t, -1,
                                                           -1, -1)])
            dep = torch.cat([dep, dep[-1:].expand(t_pad - t, -1, -1)])

        info = {}
        pos, logd, vis, fmap0 = dense_track(
            self.model.params, frames, dep, cfg, t_pad, info=info)
        self.model.last_info = info
        uv, depth, visp = densify(self.model.params, pos, logd, vis, cfg,
                                  fmap0)
        uv, depth, visp = uv[:t], depth[:t], visp[:t]

        hd, wd = cfg.dense_reso
        if downsample and downsample > 1:
            uv = uv.reshape(t, hd, wd, 2)[:, ::downsample, ::downsample]
            depth = depth.reshape(t, hd, wd)[:, ::downsample, ::downsample]
            visp = visp.reshape(t, hd, wd)[:, ::downsample, ::downsample]
            hd, wd = uv.shape[1], uv.shape[2]
            uv = uv.reshape(t, hd * wd, 2)
            depth = depth.reshape(t, hd * wd)
            visp = visp.reshape(t, hd * wd)
        # rescale to input pixel coordinates
        uv = uv * torch.tensor([w_in / wm, h_in / hm], device=dev)
        return {
            "trajs_uv": uv[None],                          # [1, T, N, 2]
            "vis": visp[None],                             # [1, T, N]
            "trajs_depth": depth[None, ..., None],         # [1, T, N, 1]
            "dense_reso": (hd, wd),
        }


# ---------------------------------------------------------------------------
# torch checkpoint mapping (best-effort)
# ---------------------------------------------------------------------------


def map_torch_state_dict(params: dict, state_dict: dict,
                         strict: bool = False):
    """Best-effort densetrack3d.pth -> params mapping, JAX's: the DELTA
    source is absent from the reference snapshot, so tensors are matched by
    SHAPE signature, greedily, in the JAX tree's flatten order (dict keys
    sorted), each leaf taking the first unused tensor of its shape (a conv
    kernel also takes a torch OIHW tensor whose transpose has its HWIO
    shape). The port visits its leaves in that order and compares JAX's
    shapes, so every tensor lands on the same leaf as in JAX. Returns the
    new params and the report of loaded / missed tree paths and unused
    checkpoint keys (`jax.tree_util.keystr` paths)."""
    items = []
    for k, v in state_dict.items():
        if not hasattr(v, "shape"):
            continue
        items.append((k, v if torch.is_tensor(v)
                      else torch.as_tensor(np.asarray(v))))
    used = set()
    loaded, missed, new = [], [], {}
    for path, leaf in _jax_leaves(params):
        want = _jax_shape(path, leaf)
        found = None
        for k, v in items:
            if k in used:
                continue
            if tuple(v.shape) == want:
                found = v
            elif v.dim() == 4 and len(want) == 4 and tuple(
                    v.permute(2, 3, 1, 0).shape) == want:
                found = v.permute(2, 3, 1, 0)
            if found is not None:
                used.add(k)
                break
        if found is not None:
            if _is_conv(path, leaf):               # HWIO -> the port's OIHW
                found = found.permute(3, 2, 0, 1)
            loaded.append(path)
            new[path] = found.to(device=leaf.device,
                                 dtype=leaf.dtype).contiguous()
        else:
            missed.append(path)
            new[path] = leaf
    report = {"loaded": loaded, "missed": missed,
              "unused": [k for k, _ in items if k not in used]}
    if strict and (missed or report["unused"]):
        raise ValueError(f"strict load failed: {report}")
    return _replace_leaves(params, new), report


def read_state_dict(path: str, names: Tuple[str, ...] = ()) -> dict:
    """The tensors of a shape-mapped checkpoint as JAX's loaders read them:
    a directory resolves to the first of `names` it holds; `.safetensors`
    through the port's own reader, any other file through
    `torch.load(weights_only=True)` (tensors and plain containers only),
    unwrapped from {"model": ...} and widened to float32."""
    from flexam_tpu_torch.io.checkpoints import read_safetensors

    if os.path.isdir(path):
        for name in names:
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
    if path.endswith(".safetensors"):
        return dict(read_safetensors(path).items())
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    return {k: v.float() for k, v in sd.items() if torch.is_tensor(v)}


def load_densetrack3d(path: str, model: Optional[DenseTrack3D] = None,
                      verify: bool = True, coverage_threshold: float = 0.9,
                      device="cuda", **cfg_kwargs) -> DenseTrack3D:
    """Load `densetrack3d.pth` (torch, optionally {"model": ...}-wrapped,
    `pipelines.py:1383-1388`) into a DenseTrack3D on `device` (or into
    `model`, on its device), best-effort.

    The mapping is by shape signature, so the result carries a verdict:
    `model.load_report` (the loaded/missed/unused lists) and
    `model.load_ok` (per-module coverage >= threshold with no module left
    entirely random — `io/verify_load.check_mapping`). The file is read
    with `weights_only=True`: tensors and plain containers."""
    from flexam_tpu_torch.io.verify_load import check_mapping

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in sd:
        sd = sd["model"]
    sd = {k: v.float() for k, v in sd.items() if torch.is_tensor(v)}
    model = model or DenseTrack3D(device=device, **cfg_kwargs)
    report = model.load_state_dict(sd, strict=False)
    model.load_report = report
    model.load_ok = check_mapping(report, quiet=True,
                                  threshold=coverage_threshold)
    n_l, n_m = len(report["loaded"]), len(report["missed"])
    print(f"densetrack3d: mapped {n_l} tensors, {n_m} unmatched "
          f"(strict=False, like the reference)")
    if verify and not model.load_ok:
        check_mapping(report, name=f"densetrack3d[{path}]",
                      threshold=coverage_threshold)
        print("WARNING: densetrack3d checkpoint mapping is LOW-COVERAGE — "
              "unmatched modules stay at random init")
    return model
