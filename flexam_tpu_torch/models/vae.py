"""Wan2.2 (3.8) causal 3D video VAE in PyTorch, whole clip.

Port of `flexam_tpu/models/vae.py`: every op is one whole-clip convolution
whose output equals the reference's frame-streamed computation (causal
time padding, the frame-0 bypass of the temporal resamplers, AvgDown3D and
DupUp3D). The JAX version computes channels-last; this port keeps torch's
channels-first [B, C, T, H, W] throughout, which is also the public layout,
and sends every convolution to cuDNN through `F.conv3d`. It runs no kernel
of its own. Group streaming lives in `models/vae_stream.py`.

Under `parallel/vae_parallel.py` each rank holds a slice of the width:
`_width_split` is then set, the convolutions of width > 1 take their halo
columns from the neighbouring ranks (zeros only at the clip's edges), and
the mid-block spatial attention sees the whole width.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flexam_tpu_torch.config import VAEConfig
from flexam_tpu_torch.device import resolve_device


# ---------------------------------------------------------------------------
# Primitive ops (channels-first)
# ---------------------------------------------------------------------------

# the width split of `parallel/vae_parallel.py` (None: the whole width);
# an object with `halo(x, left, right)` and `whole(x)` / `local(x)`
_width_split = None

def causal_conv3d(x: torch.Tensor, p: dict,
                  stride: Tuple[int, int, int] = (1, 1, 1),
                  time_pad: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Causal 3D conv on [B, C, T, H, W]; weight [O, I, kt, kh, kw]. Time is
    padded 2*(kt//2) on the left by default, space symmetrically."""
    w = p["weight"].to(x.dtype)
    kt, kh, kw = w.shape[2:]
    if time_pad is None:
        time_pad = (2 * (kt // 2), 0)
    if time_pad != (0, 0):
        x = F.pad(x, (0, 0, 0, 0) + tuple(time_pad))
    pad_w = kw // 2
    if _width_split is not None and pad_w:
        x, pad_w = _width_split.halo(x, pad_w, pad_w), 0
    return F.conv3d(x, w, p["bias"].to(x.dtype), stride=stride,
                    padding=(0, kh // 2, pad_w))


def conv2d(x: torch.Tensor, p: dict, stride: int = 1,
           padding=((1, 1), (1, 1))) -> torch.Tensor:
    """Per-frame 2D conv on [B, C, T, H, W]; weight [O, I, kh, kw]."""
    (pt, pb), (pl, pr) = padding
    if _width_split is not None and (pl or pr):
        # the neighbours' columns; zeros (the padding) at the clip's edges
        x, pl, pr = _width_split.halo(x, pl, pr), 0, 0
    x = F.pad(x, (pl, pr, pt, pb))
    return F.conv3d(x, p["weight"].to(x.dtype)[:, :, None],
                    p["bias"].to(x.dtype), stride=(1, stride, stride))


def channel_rms_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """F.normalize over channels * sqrt(C) * gamma; fp32 norm."""
    norm = torch.linalg.vector_norm(x, ord=2, dim=1, keepdim=True,
                                    dtype=torch.float32).clamp_min(1e-12)
    inv = (math.sqrt(x.shape[1]) / norm).to(x.dtype)
    return x * inv * gamma.to(x.dtype).reshape(1, -1, 1, 1, 1)


def _silu(x):
    return x * torch.sigmoid(x)


def residual_block(x: torch.Tensor, p: dict) -> torch.Tensor:
    h = causal_conv3d(x, p["shortcut"]) if "shortcut" in p else x
    y = causal_conv3d(_silu(channel_rms_norm(x, p["norm1"])), p["conv1"])
    y = causal_conv3d(_silu(channel_rms_norm(y, p["norm2"])), p["conv2"])
    return y + h


def attention_block(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Per-frame single-head spatial self-attention; qkv/proj 1x1 convs.
    Under a width split it runs on the whole width and keeps this rank's
    columns."""
    if _width_split is not None:
        return _width_split.local(_attention_block(_width_split.whole(x), p))
    return _attention_block(x, p)


def _attention_block(x: torch.Tensor, p: dict) -> torch.Tensor:
    b, c, t, h, w = x.shape
    xn = channel_rms_norm(x, p["norm"])
    tokens = xn.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)
    qkv = torch.matmul(tokens, p["to_qkv"]["weight"][:, :, 0, 0]
                       .to(x.dtype).t()) + p["to_qkv"]["bias"].to(x.dtype)
    q, k, v = qkv.split(c, dim=-1)
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * c ** -0.5
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.matmul(probs.float(), v.float()).to(x.dtype)
    o = torch.matmul(o, p["proj"]["weight"][:, :, 0, 0].to(x.dtype).t()) \
        + p["proj"]["bias"].to(x.dtype)
    o = o.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
    return o + x


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, C, T, H, W] -> [B, C*p*p, T, H/p, W/p], channel order (c, r, q)
    with r the w-offset and q the h-offset."""
    if patch == 1:
        return x
    b, c, t, h, w = x.shape
    x = x.reshape(b, c, t, h // patch, patch, w // patch, patch)
    x = x.permute(0, 1, 6, 4, 2, 3, 5)               # b c r q t h w
    return x.reshape(b, c * patch * patch, t, h // patch, w // patch)


def unpatchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """Inverse of `patchify`."""
    if patch == 1:
        return x
    b, cp, t, h, w = x.shape
    c = cp // (patch * patch)
    x = x.reshape(b, c, patch, patch, t, h, w)        # b c r q t h w
    x = x.permute(0, 1, 4, 5, 3, 6, 2)                # b c t h q w r
    return x.reshape(b, c, t, h * patch, w * patch)


def avg_down3d(x: torch.Tensor, out_channels: int, factor_t: int,
               factor_s: int = 1) -> torch.Tensor:
    """Left-pad T to a multiple of factor_t, fold (t, h, w) factors into
    channels (order c, ft, fsh, fsw) and average groups down to
    out_channels."""
    b, c, t, h, w = x.shape
    pad_t = (factor_t - t % factor_t) % factor_t
    if pad_t:
        x = F.pad(x, (0, 0, 0, 0, pad_t, 0))
        t += pad_t
    fs = factor_s
    x = x.reshape(b, c, t // factor_t, factor_t, h // fs, fs, w // fs, fs)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)             # b c ft fh fw t h w
    factor = factor_t * fs * fs
    x = x.reshape(b, out_channels, c * factor // out_channels,
                  t // factor_t, h // fs, w // fs)
    return x.mean(dim=2)


def dup_up3d(x: torch.Tensor, out_channels: int, factor_t: int,
             factor_s: int = 1, first_chunk: bool = False) -> torch.Tensor:
    """Duplicate channels, then unfold them into (t, h, w) factors;
    `first_chunk` drops the leading factor_t - 1 frames."""
    b, c, t, h, w = x.shape
    fs = factor_s
    factor = factor_t * fs * fs
    x = x.repeat_interleave(out_channels * factor // c, dim=1)
    x = x.reshape(b, out_channels, factor_t, fs, fs, t, h, w)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)             # b c t ft h fh w fw
    x = x.reshape(b, out_channels, t * factor_t, h * fs, w * fs)
    if first_chunk and factor_t > 1:
        x = x[:, :, factor_t - 1:]
    return x


def _upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)


def resample(x: torch.Tensor, p: dict, mode: str) -> torch.Tensor:
    """Whole-clip resamplers. upsample3d: frames 1.. through the causal
    time conv with zero history, channel pairs -> 2x frames, frame 0 kept,
    then 2x space + conv. downsample3d: padded stride-2 spatial conv, then
    stride-2 valid time windows (0,1,2),(2,3,4).., frame 0 kept."""
    if mode == "upsample3d":
        head, tail = x[:, :, :1], x[:, :, 1:]
        if tail.shape[2] > 0:
            y = causal_conv3d(tail, p["time_conv"])      # [B, 2C, T-1, H, W]
            b, c2, tm1, h, w = y.shape
            y = y.reshape(b, 2, c2 // 2, tm1, h, w).permute(0, 2, 3, 1, 4, 5)
            x = torch.cat([head, y.reshape(b, c2 // 2, 2 * tm1, h, w)], dim=2)
        return conv2d(_upsample_nearest2x(x), p["resample_conv"])
    if mode == "upsample2d":
        return conv2d(_upsample_nearest2x(x), p["resample_conv"])
    if mode in ("downsample2d", "downsample3d"):
        x = conv2d(x, p["resample_conv"], stride=2, padding=((0, 1), (0, 1)))
        if mode == "downsample3d":
            # fewer frames than the kernel: no valid window, frame 0 only
            if x.shape[2] < p["time_conv"]["weight"].shape[2]:
                return x[:, :, :1]
            y = causal_conv3d(x, p["time_conv"], stride=(2, 1, 1),
                              time_pad=(0, 0))
            x = torch.cat([x[:, :, :1], y], dim=2)
        return x
    return x


# ---------------------------------------------------------------------------
# Encoder / Decoder
# ---------------------------------------------------------------------------

def _down_residual_block(x, p, out_channels, temporal_down, down_flag):
    shortcut = avg_down3d(x, out_channels, factor_t=2 if temporal_down else 1,
                          factor_s=2 if down_flag else 1)
    y = x
    for rp in p["res"]:
        y = residual_block(y, rp)
    if down_flag:
        y = resample(y, p["down"],
                     "downsample3d" if temporal_down else "downsample2d")
    return y + shortcut


def _up_residual_block(x, p, out_channels, temporal_up, up_flag, first_chunk):
    y = x
    for rp in p["res"]:
        y = residual_block(y, rp)
    if up_flag:
        y = resample(y, p["up"], "upsample3d" if temporal_up else "upsample2d")
        return y + dup_up3d(x, out_channels, factor_t=2 if temporal_up else 1,
                            factor_s=2, first_chunk=first_chunk)
    return y


def encoder3d(x: torch.Tensor, p: dict, cfg: VAEConfig) -> torch.Tensor:
    dims = [cfg.c_dim * u for u in (1,) + tuple(cfg.dim_mult)]
    x = causal_conv3d(x, p["conv1"])
    for i in range(len(cfg.dim_mult)):
        t_down = (cfg.temporal_downsample[i]
                  if i < len(cfg.temporal_downsample) else False)
        x = _down_residual_block(x, p["downsamples"][i], dims[i + 1], t_down,
                                 i != len(cfg.dim_mult) - 1)
    x = residual_block(x, p["middle"][0])
    x = attention_block(x, p["middle"][1])
    x = residual_block(x, p["middle"][2])
    x = _silu(channel_rms_norm(x, p["head_norm"]))
    return causal_conv3d(x, p["head_conv"])


def decoder3d(x: torch.Tensor, p: dict, cfg: VAEConfig) -> torch.Tensor:
    dim_mult = tuple(cfg.dim_mult)
    temporal_up = tuple(reversed(cfg.temporal_downsample))
    dims = [cfg.dec_dim * u for u in (dim_mult[-1],) + tuple(reversed(dim_mult))]
    x = causal_conv3d(x, p["conv1"])
    x = residual_block(x, p["middle"][0])
    x = attention_block(x, p["middle"][1])
    x = residual_block(x, p["middle"][2])
    for i in range(len(dim_mult)):
        t_up = temporal_up[i] if i < len(temporal_up) else False
        x = _up_residual_block(x, p["upsamples"][i], dims[i + 1], t_up,
                               i != len(dim_mult) - 1, first_chunk=True)
    x = _silu(channel_rms_norm(x, p["head_norm"]))
    return causal_conv3d(x, p["head_conv"])


def _stats(params, like):
    c = (1, -1, 1, 1, 1)
    return (params["latents_mean"].to(like.dtype).reshape(c),
            params["latents_inv_std"].to(like.dtype).reshape(c))


def vae_encode(params: dict, cfg: VAEConfig, x: torch.Tensor):
    """Video [B, 3, T, H, W] in [-1, 1] -> (mu, log_var), each
    [B, z, T', H/16, W/16]; mu normalized by the per-channel stats."""
    out = encoder3d(patchify(x, 2), params["encoder"], cfg)
    out = causal_conv3d(out, params["conv1"])
    mu, log_var = out.chunk(2, dim=1)
    mean, inv_std = _stats(params, mu)
    return (mu - mean) * inv_std, log_var


def vae_encode_mode(params: dict, cfg: VAEConfig, x: torch.Tensor):
    """Deterministic encode (the posterior mode)."""
    return vae_encode(params, cfg, x)[0]


def vae_decode(params: dict, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """Latents [B, z, T', H', W'] -> video [B, 3, T, 16H', 16W'] in [-1, 1]."""
    mean, inv_std = _stats(params, z)
    x = causal_conv3d(z / inv_std + mean, params["conv2"])
    x = unpatchify(decoder3d(x, params["decoder"], cfg), 2)
    return x.clamp(-1.0, 1.0)


# ---------------------------------------------------------------------------
# Random parameters, made on the device
# ---------------------------------------------------------------------------

class ConvInit:
    """The JAX VAE init's draws (`_cconv_init`, `_res_init`, `_attn_init`,
    `_resample_init`): torch's conv default U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) for weights and biases, a zero attention projection,
    drawn on `device` from `gen` in call order."""

    def __init__(self, gen: torch.Generator, dtype, device):
        self.gen = gen
        self.kw = dict(dtype=dtype, device=device)

    def ones(self, c):
        return torch.ones((c,), **self.kw)

    def uni(self, shape, limit):
        return torch.empty(shape, **self.kw).uniform_(-limit, limit,
                                                      generator=self.gen)

    def cconv(self, out_c, in_c, k):
        limit = math.sqrt(1.0 / (in_c * math.prod(k)))
        return {"weight": self.uni((out_c, in_c, *k), limit),
                "bias": self.uni((out_c,), limit)}

    def res(self, in_c, out_c):
        p = {"norm1": self.ones(in_c),
             "conv1": self.cconv(out_c, in_c, (3, 3, 3)),
             "norm2": self.ones(out_c),
             "conv2": self.cconv(out_c, out_c, (3, 3, 3))}
        if in_c != out_c:
            p["shortcut"] = self.cconv(out_c, in_c, (1, 1, 1))
        return p

    def attn(self, c):
        return {"norm": self.ones(c),
                "to_qkv": {"weight": self.cconv(3 * c, c, (1, 1))["weight"],
                           "bias": torch.zeros((3 * c,), **self.kw)},
                "proj": {"weight": torch.zeros((c, c, 1, 1), **self.kw),
                         "bias": torch.zeros((c,), **self.kw)}}

    def resamp(self, dim, mode):
        p = {"resample_conv": self.cconv(dim, dim, (3, 3))}
        if mode == "upsample3d":
            p["time_conv"] = self.cconv(dim * 2, dim, (3, 1, 1))
        if mode == "downsample3d":
            p["time_conv"] = self.cconv(dim, dim, (3, 1, 1))
        return p


def init_vae_params(cfg: VAEConfig, seed: int = 0, dtype=torch.bfloat16,
                    device="cuda") -> dict:
    """Random parameters with the JAX init's distributions (torch's conv
    default U(-1/sqrt(fan_in), 1/sqrt(fan_in)); zero attention projection),
    drawn on the device from a `torch.Generator` seeded with `seed`."""
    dev = resolve_device(device)
    d = ConvInit(torch.Generator(device=dev).manual_seed(seed), dtype, dev)
    cconv, res, attn, resamp = d.cconv, d.res, d.attn, d.resamp
    kw = d.kw

    z = cfg.latent_channels
    dim_mult = tuple(cfg.dim_mult)
    enc_dims = [cfg.c_dim * u for u in (1,) + dim_mult]
    enc = {"conv1": cconv(enc_dims[0], 12, (3, 3, 3)), "downsamples": []}
    for i, (din, dout) in enumerate(zip(enc_dims[:-1], enc_dims[1:])):
        blk = {"res": [res(din if j == 0 else dout, dout)
                       for j in range(cfg.num_res_blocks)]}
        if i != len(dim_mult) - 1:
            t_down = (cfg.temporal_downsample[i]
                      if i < len(cfg.temporal_downsample) else False)
            blk["down"] = resamp(dout, "downsample3d" if t_down
                                 else "downsample2d")
        enc["downsamples"].append(blk)
    mid = enc_dims[-1]
    enc["middle"] = [res(mid, mid), attn(mid), res(mid, mid)]
    enc["head_norm"] = torch.ones((mid,), **kw)
    enc["head_conv"] = cconv(z * 2, mid, (3, 3, 3))

    temporal_up = tuple(reversed(cfg.temporal_downsample))
    dec_dims = [cfg.dec_dim * u for u in (dim_mult[-1],) + tuple(reversed(dim_mult))]
    dec = {"conv1": cconv(dec_dims[0], z, (3, 3, 3)),
           "middle": [res(dec_dims[0], dec_dims[0]), attn(dec_dims[0]),
                      res(dec_dims[0], dec_dims[0])],
           "upsamples": []}
    for i, (din, dout) in enumerate(zip(dec_dims[:-1], dec_dims[1:])):
        blk = {"res": [res(din if j == 0 else dout, dout)
                       for j in range(cfg.num_res_blocks + 1)]}
        if i != len(dim_mult) - 1:
            t_up = temporal_up[i] if i < len(temporal_up) else False
            blk["up"] = resamp(dout, "upsample3d" if t_up else "upsample2d")
        dec["upsamples"].append(blk)
    dec["head_norm"] = torch.ones((dec_dims[-1],), **kw)
    dec["head_conv"] = cconv(12, dec_dims[-1], (3, 3, 3))

    mean, inv_std = latent_stats(z)
    return {"encoder": enc, "decoder": dec,
            "conv1": cconv(z * 2, z * 2, (1, 1, 1)),
            "conv2": cconv(z, z, (1, 1, 1)),
            "latents_mean": torch.from_numpy(mean).to(dev),
            "latents_inv_std": torch.from_numpy(inv_std).to(dev)}


def latent_stats(z_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """The 48-channel latent mean and 1/std (zeros/ones for other z)."""
    if z_dim != 48:
        return np.zeros((z_dim,), np.float32), np.ones((z_dim,), np.float32)
    mean = np.array([
        -0.2289, -0.0052, -0.1323, -0.2339, -0.2799, 0.0174, 0.1838, 0.1557,
        -0.1382, 0.0542, 0.2813, 0.0891, 0.1570, -0.0098, 0.0375, -0.1825,
        -0.2246, -0.1207, -0.0698, 0.5109, 0.2665, -0.2108, -0.2158, 0.2502,
        -0.2055, -0.0322, 0.1109, 0.1567, -0.0729, 0.0899, -0.2799, -0.1230,
        -0.0313, -0.1649, 0.0117, 0.0723, -0.2839, -0.2083, -0.0520, 0.3748,
        0.0152, 0.1957, 0.1433, -0.2944, 0.3573, -0.0548, -0.1681, -0.0667,
    ], np.float32)
    std = np.array([
        0.4765, 1.0364, 0.4514, 1.1677, 0.5313, 0.4990, 0.4818, 0.5013,
        0.8158, 1.0344, 0.5894, 1.0901, 0.6885, 0.6165, 0.8454, 0.4978,
        0.5759, 0.3523, 0.7135, 0.6804, 0.5833, 1.4146, 0.8986, 0.5659,
        0.7069, 0.5338, 0.4889, 0.4917, 0.4069, 0.4999, 0.6866, 0.4093,
        0.5709, 0.6065, 0.6415, 0.4944, 0.5726, 1.2042, 0.5458, 1.6887,
        0.3971, 1.0600, 0.3943, 0.5537, 0.5444, 0.4089, 0.7468, 0.7744,
    ], np.float32)
    return mean, 1.0 / std
