"""Wan2.1 causal video VAE (8x spatial / 4x temporal, 16 latent channels).

Port of `flexam_tpu/models/vae21.py` (reference `FlexAM/models/wan_vae.py`,
`AutoencoderKLWan_`), built on the port's `models/vae.py` blocks as JAX
builds it on its own. Against the Wan2.2 VAE: no 2x pixel patchify (the
encoder's conv1 takes RGB), the decoder's upsample convs halve the
channels (with the matching halved input at each up-stage start), no
AvgDown3D / DupUp3D shortcuts, dim 96, z 16 and the 16-channel latent
stats. The encoder's and decoder's stages are one flat list each
(`downsamples` / `upsamples`, residual blocks then a resampler, as the
reference's nn.Sequential), so the tree and the state dict share indices.

Channels-first [B, C, T, H, W] throughout, as the port's other VAEs;
`io.convert.from_jax_params` carries JAX's tree across unchanged (its
kernels are in torch layout already).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from flexam_tpu_torch.device import resolve_device
from flexam_tpu_torch.models.vae import (ConvInit, _silu, attention_block,
                                         causal_conv3d, channel_rms_norm,
                                         residual_block, resample)


@dataclass(frozen=True)
class VAE21Config:
    latent_channels: int = 16
    dim: int = 96
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True)


def _middle(x: torch.Tensor, p: list) -> torch.Tensor:
    x = residual_block(x, p[0])
    x = attention_block(x, p[1])
    return residual_block(x, p[2])


def _head(x: torch.Tensor, p: dict) -> torch.Tensor:
    return causal_conv3d(_silu(channel_rms_norm(x, p["head_norm"])),
                         p["head_conv"])


def encoder3d_21(x: torch.Tensor, p: dict, cfg: VAE21Config) -> torch.Tensor:
    """`Encoder3d.forward` (`wan_vae.py:269-371`); x [B, 3, T, H, W]."""
    x = causal_conv3d(x, p["conv1"])
    li = 0
    for i in range(len(cfg.dim_mult)):
        for _ in range(cfg.num_res_blocks):
            x = residual_block(x, p["downsamples"][li])
            li += 1
        if i != len(cfg.dim_mult) - 1:
            mode = ("downsample3d" if cfg.temporal_downsample[i]
                    else "downsample2d")
            x = resample(x, p["downsamples"][li], mode)
            li += 1
    return _head(_middle(x, p["middle"]), p)


def decoder3d_21(x: torch.Tensor, p: dict, cfg: VAE21Config) -> torch.Tensor:
    """`Decoder3d.forward` (`wan_vae.py:373-485`), channel-halving
    upsamples; x [B, z, T, H, W]."""
    temporal_up = tuple(reversed(cfg.temporal_downsample))
    x = _middle(causal_conv3d(x, p["conv1"]), p["middle"])
    li = 0
    for i in range(len(cfg.dim_mult)):
        for _ in range(cfg.num_res_blocks + 1):
            x = residual_block(x, p["upsamples"][li])
            li += 1
        if i != len(cfg.dim_mult) - 1:
            mode = "upsample3d" if temporal_up[i] else "upsample2d"
            x = resample(x, p["upsamples"][li], mode)
            li += 1
    return _head(x, p)


def _stats(params, like):
    c = (1, -1, 1, 1, 1)
    return (params["latents_mean"].to(like.dtype).reshape(c),
            params["latents_inv_std"].to(like.dtype).reshape(c))


def vae21_encode(params, cfg: VAE21Config, x: torch.Tensor):
    """[B, 3, T, H, W] in [-1, 1] -> (mu, log_var) [B, z, T', H/8, W/8];
    mu normalized by the latent stats."""
    out = causal_conv3d(encoder3d_21(x, params["encoder"], cfg),
                        params["conv1"])
    mu, log_var = out.chunk(2, dim=1)
    mean, inv_std = _stats(params, mu)
    return (mu - mean) * inv_std, log_var


def vae21_decode(params, cfg: VAE21Config, z: torch.Tensor) -> torch.Tensor:
    """[B, z, T', H', W'] -> video [B, 3, T, 8H', 8W'] in [-1, 1]."""
    mean, inv_std = _stats(params, z)
    x = causal_conv3d(z / inv_std + mean, params["conv2"])
    return decoder3d_21(x, params["decoder"], cfg).clamp(-1.0, 1.0)


def init_vae21_params(cfg: VAE21Config, seed: int = 0, dtype=torch.bfloat16,
                      device="cuda") -> dict:
    """Random parameters with the JAX init's distributions, drawn on the
    device from a `torch.Generator` seeded with `seed`."""
    dev = resolve_device(device)
    d = ConvInit(torch.Generator(device=dev).manual_seed(seed), dtype, dev)
    z = cfg.latent_channels
    mult = tuple(cfg.dim_mult)
    enc_dims = [cfg.dim * u for u in (1,) + mult]

    enc = {"conv1": d.cconv(enc_dims[0], 3, (3, 3, 3)), "downsamples": []}
    for i, (din, dout) in enumerate(zip(enc_dims[:-1], enc_dims[1:])):
        cur = din
        for _ in range(cfg.num_res_blocks):
            enc["downsamples"].append(d.res(cur, dout))
            cur = dout
        if i != len(mult) - 1:
            enc["downsamples"].append(d.resamp(
                dout, "downsample3d" if cfg.temporal_downsample[i]
                else "downsample2d"))
    mid = enc_dims[-1]
    enc["middle"] = [d.res(mid, mid), d.attn(mid), d.res(mid, mid)]
    enc["head_norm"] = d.ones(mid)
    enc["head_conv"] = d.cconv(z * 2, mid, (3, 3, 3))

    dec_dims = [cfg.dim * u for u in (mult[-1],) + tuple(reversed(mult))]
    temporal_up = tuple(reversed(cfg.temporal_downsample))
    top = dec_dims[0]
    dec = {"conv1": d.cconv(top, z, (3, 3, 3)),
           "middle": [d.res(top, top), d.attn(top), d.res(top, top)],
           "upsamples": []}
    for i, (din, dout) in enumerate(zip(dec_dims[:-1], dec_dims[1:])):
        cur = din if i == 0 else din // 2        # (`wan_vae.py:408-409`)
        for _ in range(cfg.num_res_blocks + 1):
            dec["upsamples"].append(d.res(cur, dout))
            cur = dout
        if i != len(mult) - 1:
            p = d.resamp(dout, "upsample3d" if temporal_up[i]
                         else "upsample2d")
            # the spatial conv halves the channels (`wan_vae.py:81-89`)
            p["resample_conv"] = d.cconv(dout // 2, dout, (3, 3))
            dec["upsamples"].append(p)
    dec["head_norm"] = d.ones(dec_dims[-1])
    dec["head_conv"] = d.cconv(3, dec_dims[-1], (3, 3, 3))

    mean, inv_std = wan21_latent_stats(z)
    return {"encoder": enc, "decoder": dec,
            "conv1": d.cconv(z * 2, z * 2, (1, 1, 1)),
            "conv2": d.cconv(z, z, (1, 1, 1)),
            "latents_mean": torch.from_numpy(mean).to(dev),
            "latents_inv_std": torch.from_numpy(inv_std).to(dev)}


def wan21_latent_stats(z_dim: int):
    """The 16-channel latent mean and 1/std (`wan_vae.py:627-637`); zeros
    and ones for other widths."""
    if z_dim != 16:
        return np.zeros((z_dim,), np.float32), np.ones((z_dim,), np.float32)
    mean = np.array([
        -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
        0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
    ], np.float32)
    std = np.array([
        2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
        3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
    ], np.float32)
    return mean, 1.0 / std


def _stages(cfg: VAE21Config, extra_res: int):
    """(module kind, index) of one side's flat stage list in order: 'res'
    or 'resample' (`wan_vae.py:294-321,400-427`)."""
    out = []
    for i in range(len(cfg.dim_mult)):
        out += ["res"] * (cfg.num_res_blocks + extra_res)
        if i != len(cfg.dim_mult) - 1:
            out.append("resample")
    return out


def vae21_params_from_state_dict(sd: Mapping, cfg: VAE21Config,
                                 device="cuda") -> dict:
    """`AutoencoderKLWan_` state dict -> the tree on `device` (the stage
    indices follow the reference's flat nn.Sequential layout)."""
    from flexam_tpu_torch.io.checkpoints import (_attn_from_sd, _conv,
                                                 _gamma, _res_from_sd,
                                                 _resample_from_sd)
    dev = resolve_device(device)
    read = {"res": _res_from_sd, "resample": _resample_from_sd}

    def side(name, stages, extra):
        return {
            "conv1": _conv(sd, f"{name}.conv1", dev),
            stages: [read[kind](sd, f"{name}.{stages}.{i}", dev)
                     for i, kind in enumerate(_stages(cfg, extra))],
            "middle": [_res_from_sd(sd, f"{name}.middle.0", dev),
                       _attn_from_sd(sd, f"{name}.middle.1", dev),
                       _res_from_sd(sd, f"{name}.middle.2", dev)],
            "head_norm": _gamma(sd, f"{name}.head.0.gamma", dev),
            "head_conv": _conv(sd, f"{name}.head.2", dev),
        }

    mean, inv_std = wan21_latent_stats(cfg.latent_channels)
    return {"encoder": side("encoder", "downsamples", 0),
            "decoder": side("decoder", "upsamples", 1),
            "conv1": _conv(sd, "conv1", dev), "conv2": _conv(sd, "conv2", dev),
            "latents_mean": torch.from_numpy(mean).to(dev),
            "latents_inv_std": torch.from_numpy(inv_std).to(dev)}


def vae21_state_dict(params: dict, cfg: VAE21Config
                     ) -> Dict[str, torch.Tensor]:
    """The reference-named state dict of a tree (the inverse of
    `vae21_params_from_state_dict`), RMS gammas in the reference's
    broadcast shapes."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(prefix, p):
        sd[prefix + ".weight"] = p["weight"]
        sd[prefix + ".bias"] = p["bias"]

    def res(prefix, p):
        sd[f"{prefix}.residual.0.gamma"] = p["norm1"].reshape(-1, 1, 1, 1)
        conv(f"{prefix}.residual.2", p["conv1"])
        sd[f"{prefix}.residual.3.gamma"] = p["norm2"].reshape(-1, 1, 1, 1)
        conv(f"{prefix}.residual.6", p["conv2"])
        if "shortcut" in p:
            conv(f"{prefix}.shortcut", p["shortcut"])

    def resamp(prefix, p):
        conv(f"{prefix}.resample.1", p["resample_conv"])
        if "time_conv" in p:
            conv(f"{prefix}.time_conv", p["time_conv"])

    for name, stages, extra in (("encoder", "downsamples", 0),
                                ("decoder", "upsamples", 1)):
        tree = params[name]
        conv(f"{name}.conv1", tree["conv1"])
        for i, kind in enumerate(_stages(cfg, extra)):
            (res if kind == "res" else resamp)(f"{name}.{stages}.{i}",
                                               tree[stages][i])
        res(f"{name}.middle.0", tree["middle"][0])
        mid = tree["middle"][1]
        sd[f"{name}.middle.1.norm.gamma"] = mid["norm"].reshape(-1, 1, 1)
        conv(f"{name}.middle.1.to_qkv", mid["to_qkv"])
        conv(f"{name}.middle.1.proj", mid["proj"])
        res(f"{name}.middle.2", tree["middle"][2])
        sd[f"{name}.head.0.gamma"] = tree["head_norm"].reshape(-1, 1, 1, 1)
        conv(f"{name}.head.2", tree["head_conv"])
    conv("conv1", params["conv1"])
    conv("conv2", params["conv2"])
    return sd
