"""FLUX image autoencoder (AutoencoderKL, 16 latent channels).

Port of `flexam_tpu/models/flux_vae.py`: the SD-style KL autoencoder at
the FLUX geometry (ch 128, mult (1, 2, 4, 4), 2 res blocks a level, mid
attention at 512, z = 16 with a double-z encoder output) and FLUX's
scale/shift convention ``z = scale * (sample - shift)``. DepthCrafter's
VAE is the same module at SD geometry (`perception/depthcrafter_model.py
SD_VAE_CONFIG`).

JAX runs NHWC with HWIO kernels; the port runs NCHW with torch's OIHW
kernels, for cuDNN (`io/convert.py` transposes the JAX trees, the loader
reads `ae.safetensors` as it is). The encoder's strided downsample pads
(0, 1) x (0, 1) as the reference does; the decoder upsamples nearest-2x
then convolves. The mid blocks' single-head attention over H*W tokens is a
plain product in fp32 logits, as in JAX (not the attention dispatcher).

The loader is JAX's exact name map over the official ``ae.safetensors``
layout (``encoder.down.N.block.M.*``, ``decoder.up.N.*``, CompVis naming,
``decoder.up`` indexed by level and run high index first), with its
coverage report for `io/verify_load`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from flexam_tpu_torch.core.layers import ParamDraw, group_norm, silu
from flexam_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class FluxVAEConfig:
    in_channels: int = 3
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 16
    scale_factor: float = 0.3611
    shift_factor: float = 0.1159

    @classmethod
    def tiny(cls) -> "FluxVAEConfig":
        # ch must stay a multiple of 32 (GroupNorm(32), like the model)
        return cls(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4)


def _conv(x: torch.Tensor, p: dict, stride: int = 1,
          pad: bool = True) -> torch.Tensor:
    """NCHW conv; p = {"w": [out, in, kh, kw], "b": [out]}; `pad` keeps
    the size (JAX's SAME at stride 1), else VALID."""
    w = p["w"].to(x.dtype)
    return F.conv2d(x, w, p["b"].to(x.dtype), stride=stride,
                    padding=w.shape[-1] // 2 if pad else 0)


def _gn(x: torch.Tensor, p: dict) -> torch.Tensor:
    """GroupNorm(32, eps 1e-6) over NCHW."""
    return group_norm(x, p["w"], p["b"], num_groups=32, eps=1e-6)


def _resnet(x: torch.Tensor, p: dict) -> torch.Tensor:
    h = _conv(silu(_gn(x, p["norm1"])), p["conv1"])
    h = _conv(silu(_gn(h, p["norm2"])), p["conv2"])
    if "nin_shortcut" in p:
        x = _conv(x, p["nin_shortcut"])
    return x + h


def _attn(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Single-head spatial attention (1x1-conv q/k/v/proj, residual):
    fp32 logits and softmax, probabilities in x's dtype for P.V."""
    b, c, hh, ww = x.shape
    h = _gn(x, p["norm"])
    q, k, v = (_conv(h, p[n]).flatten(2).transpose(1, 2)
               for n in ("q", "k", "v"))                  # [B, HW, C]
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)).mul_(
        c ** -0.5)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    del logits
    out = torch.matmul(probs, v).transpose(1, 2).reshape(b, c, hh, ww)
    return x + _conv(out, p["proj_out"])


def encoder_trunk(p: dict, cfg: FluxVAEConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """The encoder up to `conv_out`: [B, 3, H, W] -> [B, 2z, H/8, W/8]."""
    h = _conv(x, p["conv_in"])
    for i in range(len(cfg.ch_mult)):
        lv = p["down"][i]
        for j in range(cfg.num_res_blocks):
            h = _resnet(h, lv["block"][j])
        if i != len(cfg.ch_mult) - 1:
            # asymmetric (0,1)x(0,1) pad, stride-2 conv (reference conv)
            h = _conv(F.pad(h, (0, 1, 0, 1)), lv["downsample"], stride=2,
                      pad=False)
    h = _resnet(h, p["mid_block_1"])
    h = _attn(h, p["mid_attn_1"])
    h = _resnet(h, p["mid_block_2"])
    return _conv(silu(_gn(h, p["norm_out"])), p["conv_out"])


def flux_vae_encode(params: dict, cfg: FluxVAEConfig, x: torch.Tensor,
                    generator: torch.Generator = None) -> torch.Tensor:
    """x: [B, 3, H, W] in [-1, 1] -> scaled latents [B, z, H/8, W/8].

    The posterior mean unless a `generator` is given (JAX's
    `sample_key`): the control-image encode of the repaint is
    mean-encoded."""
    h = encoder_trunk(params["encoder"], cfg, x)
    mean, logvar = h.chunk(2, dim=1)
    z = mean
    if generator is not None:
        logvar = logvar.clamp(-30.0, 20.0)
        z = mean + torch.exp(0.5 * logvar) * torch.randn(
            mean.shape, generator=generator, device=mean.device,
            dtype=mean.dtype)
    return cfg.scale_factor * (z - cfg.shift_factor)


def flux_vae_decode(params: dict, cfg: FluxVAEConfig,
                    z: torch.Tensor) -> torch.Tensor:
    """Scaled latents [B, z, h, w] -> image [B, 3, 8h, 8w] in [-1, 1]."""
    p = params["decoder"]
    z = z / cfg.scale_factor + cfg.shift_factor
    h = _conv(z, p["conv_in"])
    h = _resnet(h, p["mid_block_1"])
    h = _attn(h, p["mid_attn_1"])
    h = _resnet(h, p["mid_block_2"])
    for i in reversed(range(len(cfg.ch_mult))):   # up.3 first (CompVis)
        lv = p["up"][i]
        for j in range(cfg.num_res_blocks + 1):
            h = _resnet(h, lv["block"][j])
        if i != 0:
            h = _conv(F.interpolate(h, scale_factor=2, mode="nearest"),
                      lv["upsample"])
    return _conv(silu(_gn(h, p["norm_out"])), p["conv_out"])


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _vae_tree(cfg: FluxVAEConfig, draw: ParamDraw) -> dict:
    """JAX's tree and distributions (normal / sqrt(fan_in) kernels, zero
    biases, unit norms), kernels in OIHW."""
    def conv(cin, cout, k=3):
        return {"w": draw.normal((cout, cin, k, k), (cin * k * k) ** -0.5),
                "b": draw.full((cout,), 0.0)}

    def gn(c):
        return {"w": draw.full((c,), 1.0), "b": draw.full((c,), 0.0)}

    def resnet(cin, cout):
        p = {"norm1": gn(cin), "conv1": conv(cin, cout),
             "norm2": gn(cout), "conv2": conv(cout, cout)}
        if cin != cout:
            p["nin_shortcut"] = conv(cin, cout, k=1)
        return p

    def attn(c):
        return {"norm": gn(c), "q": conv(c, c, 1), "k": conv(c, c, 1),
                "v": conv(c, c, 1), "proj_out": conv(c, c, 1)}

    dims = [cfg.ch * m for m in cfg.ch_mult]
    top = dims[-1]
    enc: dict = {"conv_in": conv(cfg.in_channels, cfg.ch), "down": []}
    cin = cfg.ch
    for i, d in enumerate(dims):
        lv = {"block": []}
        for _ in range(cfg.num_res_blocks):
            lv["block"].append(resnet(cin, d))
            cin = d
        if i != len(dims) - 1:
            lv["downsample"] = conv(d, d)
        enc["down"].append(lv)
    enc.update({"mid_block_1": resnet(top, top), "mid_attn_1": attn(top),
                "mid_block_2": resnet(top, top), "norm_out": gn(top),
                "conv_out": conv(top, 2 * cfg.z_channels)})
    dec: dict = {"conv_in": conv(cfg.z_channels, top),
                 "mid_block_1": resnet(top, top), "mid_attn_1": attn(top),
                 "mid_block_2": resnet(top, top), "up": [None] * len(dims)}
    cin = top
    for i in reversed(range(len(dims))):
        lv = {"block": []}
        for _ in range(cfg.num_res_blocks + 1):
            lv["block"].append(resnet(cin, dims[i]))
            cin = dims[i]
        if i != 0:
            lv["upsample"] = conv(dims[i], dims[i])
        dec["up"][i] = lv
    dec.update({"norm_out": gn(dims[0]),
                "conv_out": conv(dims[0], cfg.in_channels)})
    return {"encoder": enc, "decoder": dec}


def init_flux_vae_params(cfg: FluxVAEConfig, seed: int = 0,
                         dtype=torch.float32, device="cuda") -> dict:
    """Random parameters with the JAX init's distributions, drawn on the
    device from a `torch.Generator` seeded with `seed`."""
    return _vae_tree(cfg, ParamDraw(seed, dtype, resolve_device(device)))


def _vae_names(cfg: FluxVAEConfig) -> Dict[str, tuple]:
    """ae.safetensors key (without .weight/.bias) -> tree path."""
    names: Dict[str, tuple] = {}
    res = ("norm1", "conv1", "norm2", "conv2", "nin_shortcut")
    for side in ("encoder", "decoder"):
        for leaf in ("conv_in", "conv_out", "norm_out"):
            names[f"{side}.{leaf}"] = (side, leaf)
        for blk in ("block_1", "block_2"):
            for leaf in res:
                names[f"{side}.mid.{blk}.{leaf}"] = (side, f"mid_{blk}", leaf)
        for leaf in ("norm", "q", "k", "v", "proj_out"):
            names[f"{side}.mid.attn_1.{leaf}"] = (side, "mid_attn_1", leaf)
    n_lv = len(cfg.ch_mult)
    for i in range(n_lv):
        for j in range(cfg.num_res_blocks):
            for leaf in res:
                names[f"encoder.down.{i}.block.{j}.{leaf}"] = (
                    "encoder", "down", i, "block", j, leaf)
        if i != n_lv - 1:
            names[f"encoder.down.{i}.downsample.conv"] = (
                "encoder", "down", i, "downsample")
    for i in range(n_lv):
        for j in range(cfg.num_res_blocks + 1):
            for leaf in res:
                names[f"decoder.up.{i}.block.{j}.{leaf}"] = (
                    "decoder", "up", i, "block", j, leaf)
        if i != 0:
            names[f"decoder.up.{i}.upsample.conv"] = (
                "decoder", "up", i, "upsample")
    return names


def _get_path(tree, path):
    """The node at `path`, or None where the tree has no such node (an
    optional leaf this geometry lacks)."""
    node = tree
    for p in path:
        if node is None:
            return None
        if isinstance(p, int):
            node = node[p] if p < len(node) else None
        else:
            node = node.get(p) if isinstance(node, dict) else None
    return node


def flux_vae_params_from_state_dict(sd: Mapping, cfg: FluxVAEConfig,
                                    dtype=torch.float32, device="cuda"
                                    ) -> Tuple[dict, Dict[str, list]]:
    """JAX's exact name map: (the port's tree on `device`, the coverage
    report). Kernels stay in torch's OIHW; optional leaves (nin_shortcut)
    count only where the geometry has them; a leaf the file lacks stays
    zero, as in JAX."""
    from flexam_tpu_torch.io.checkpoints import _source
    from flexam_tpu_torch.io.convert import leaf
    dev = resolve_device(device)
    params = _vae_tree(cfg, ParamDraw(None, dtype, dev))     # zeros
    loaded, missed, used = [], [], set()
    for sd_key, path in _vae_names(cfg).items():
        tgt = _get_path(params, path)
        if tgt is None:
            continue
        wk, bk = f"{sd_key}.weight", f"{sd_key}.bias"
        if wk not in sd or bk not in sd:
            missed.append("/".join(str(p) for p in path))
            continue
        for name, key in (("w", wk), ("b", bk)):
            t = _source(sd, key)[0]
            if tuple(t.shape) != tuple(tgt[name].shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)}, the "
                                 f"geometry wants {tuple(tgt[name].shape)}")
            tgt[name] = leaf(t, dev, dtype)
        loaded.append("/".join(str(p) for p in path))
        used.update((wk, bk))
    unused = [k for k in sd if k not in used]
    return params, {"loaded": loaded, "missed": missed, "unused": unused}


def flux_vae_state_dict(params: dict, cfg: FluxVAEConfig
                        ) -> Dict[str, torch.Tensor]:
    """The inverse map (the reference's names, OIHW kernels), for
    `io.checkpoints.save_safetensors`."""
    out = {}
    for sd_key, path in _vae_names(cfg).items():
        node = _get_path(params, path)
        if node is None:
            continue
        out[f"{sd_key}.weight"] = node["w"]
        out[f"{sd_key}.bias"] = node["b"]
    return out
