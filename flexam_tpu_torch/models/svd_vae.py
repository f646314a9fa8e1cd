"""SVD video VAE: the SD encoder and the temporal decoder.

Port of `flexam_tpu/models/svd_vae.py`. The published video-diffusion
autoencoder (the one DepthCrafter's pipe decodes through) pairs the SD KL
encoder (`models/flux_vae.py` at SD geometry, with `quant_conv`) with a
decoder whose resnets are spatio-temporal pairs (the UNet's alpha-blended
blocks without time embeddings) and a final 3-tap temporal conv on the RGB
output. NCHW frames [T, C, H, W] as the port's UNet; the mid attention
calls JAX's `xla_attention` directly, which is `core.attention.
exact_attention` here (one head, 512 wide).

The loader is the UNet's generic name map over `decoder.*` plus the image
VAE's exact map over `encoder.*`, and takes both the CompVis naming and
the video release's diffusers naming (`_translate_diffusers_vae`), as
JAX's does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from flexam_tpu_torch.core.attention import exact_attention
from flexam_tpu_torch.core.layers import ParamDraw, silu
from flexam_tpu_torch.device import resolve_device
from flexam_tpu_torch.models import flux_vae as _fv
from flexam_tpu_torch.models.flux_vae import FluxVAEConfig
from flexam_tpu_torch.models.svd_unet import (_conv2d, _conv_t, _gn,
                                              _st_resblock, flatten,
                                              load_by_names)


def _attn_wb(x, p, groups):
    """The mid block's single-head spatial attention (weight/bias names)."""
    b, c, hh, ww = x.shape
    h = _gn(x, p["norm"], groups)
    q, k, v = (_conv2d(h, p[n]).flatten(2).transpose(1, 2)[:, :, None]
               for n in ("q", "k", "v"))                   # [B, HW, 1, C]
    o = exact_attention(q, k, v).reshape(b, hh * ww, c).transpose(1, 2)
    return x + _conv2d(o.reshape(b, c, hh, ww).to(x.dtype), p["proj_out"])


@dataclass(frozen=True)
class TemporalDecoderConfig:
    z_channels: int = 4
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2            # the decoder runs layers + 1
    norm_groups: int = 32
    scale_factor: float = 0.18215

    @classmethod
    def tiny(cls) -> "TemporalDecoderConfig":
        return cls(block_out_channels=(32, 64), layers_per_block=1)


def temporal_decode(params: dict, cfg: TemporalDecoderConfig,
                    z: torch.Tensor) -> torch.Tensor:
    """SCALED latents [T, z, h, w] -> video [T, 3, H, W] in [-1, 1]; the
    whole clip at once (the temporal convs mix neighbouring frames)."""
    t = z.shape[0]
    g = cfg.norm_groups
    x = _conv2d(z / cfg.scale_factor, params["conv_in"])
    mid = params["mid_block"]
    x = _st_resblock(x, None, mid["resnets"][0], g, 1, t)
    x = _attn_wb(x, mid["attentions"][0], g)
    x = _st_resblock(x, None, mid["resnets"][1], g, 1, t)
    n = len(cfg.block_out_channels)
    for i, blk in enumerate(params["up_blocks"]):
        for rp in blk["resnets"]:
            x = _st_resblock(x, None, rp, g, 1, t)
        if i < n - 1:
            x = _conv2d(F.interpolate(x, scale_factor=2, mode="nearest"),
                        blk["upsamplers"][0]["conv"])
    x = _conv2d(silu(_gn(x, params["conv_norm_out"], g)), params["conv_out"])
    # the final 3-tap temporal conv on RGB
    return _conv_t(x.transpose(0, 1)[None], params["time_conv_out"]
                   )[0].transpose(0, 1)


def _decoder_tree(cfg: TemporalDecoderConfig, draw: ParamDraw) -> dict:
    """JAX's tree and distributions, kernels OIHW / OIDHW."""
    def conv2(ci, co, k=3):
        return {"weight": draw.normal((co, ci, k, k), (ci * k * k) ** -0.5),
                "bias": draw.full((co,), 0.0)}

    def conv3(ci, co):
        return {"weight": draw.normal((co, ci, 3, 1, 1), (3 * ci) ** -0.5),
                "bias": draw.full((co,), 0.0)}

    def norm(c):
        return {"weight": draw.full((c,), 1.0), "bias": draw.full((c,), 0.0)}

    def resnet2d(ci, co):
        p = {"norm1": norm(ci), "conv1": conv2(ci, co),
             "norm2": norm(co), "conv2": conv2(co, co)}
        if ci != co:
            p["conv_shortcut"] = conv2(ci, co, k=1)
        return p

    def st_res(ci, co):
        return {"spatial_res_block": resnet2d(ci, co),
                "temporal_res_block": {
                    "norm1": norm(co), "conv1": conv3(co, co),
                    "norm2": norm(co), "conv2": conv3(co, co)},
                "time_mixer": {"mix_factor": draw.full((1,), 0.5)}}

    def attn(c):
        return {"norm": norm(c), "q": conv2(c, c, 1), "k": conv2(c, c, 1),
                "v": conv2(c, c, 1), "proj_out": conv2(c, c, 1)}

    chans = cfg.block_out_channels
    top = chans[-1]
    params: dict = {
        "conv_in": conv2(cfg.z_channels, top),
        "mid_block": {"resnets": [st_res(top, top), st_res(top, top)],
                      "attentions": [attn(top)]},
        "up_blocks": [],
        "conv_norm_out": norm(chans[0]),
        "conv_out": conv2(chans[0], cfg.out_channels),
        "time_conv_out": conv3(cfg.out_channels, cfg.out_channels)}
    ci = top
    for i in range(len(chans)):
        co = chans[len(chans) - 1 - i]
        blk = {"resnets": []}
        for _ in range(cfg.layers_per_block + 1):
            blk["resnets"].append(st_res(ci, co))
            ci = co
        if i < len(chans) - 1:
            blk["upsamplers"] = [{"conv": conv2(co, co)}]
        params["up_blocks"].append(blk)
    return params


def init_temporal_decoder_params(cfg: TemporalDecoderConfig, seed: int = 0,
                                 dtype=torch.float32, device="cuda") -> dict:
    """Random parameters with the JAX init's distributions, drawn on the
    device from a `torch.Generator` seeded with `seed`."""
    return _decoder_tree(cfg, ParamDraw(seed, dtype, resolve_device(device)))


def svd_vae_encode(params: dict, vae_cfg: FluxVAEConfig,
                   x: torch.Tensor) -> torch.Tensor:
    """The SD encoder + quant_conv (posterior mean): [N, 3, H, W] ->
    scaled latents [N, z, H/8, W/8]."""
    h = _fv.encoder_trunk(params["encoder"], vae_cfg, x)
    if "quant_conv" in params:
        h = _fv._conv(h, params["quant_conv"])
    return vae_cfg.scale_factor * h.chunk(2, dim=1)[0]


def _translate_diffusers_vae(sd: Mapping, enc_cfg: FluxVAEConfig) -> dict:
    """The video release's diffusers naming -> the internal hybrid (JAX's
    rules): encoder `down_blocks.N.resnets.M` -> CompVis `down.N.block.M`,
    `mid_block.resnets.{0,1}` -> `mid.block_{1,2}`, attention `to_q/to_k/
    to_v/to_out.0` Linears -> `q/k/v/proj_out` 1x1 convs, `conv_norm_out`
    -> `norm_out`, `conv_shortcut` -> `nin_shortcut`; the decoder's mid
    attention likewise; everything else passes through."""
    out = {}
    n_lv = len(enc_cfg.ch_mult)
    attn_map = {"to_q": "q", "to_k": "k", "to_v": "v",
                "to_out.0": "proj_out", "group_norm": "norm"}
    for k in sd:
        v = sd[k]
        nk = k
        if k.startswith("encoder."):
            nk = nk.replace(".conv_norm_out.", ".norm_out.")
            for i in range(n_lv):
                nk = nk.replace(f"down_blocks.{i}.resnets.",
                                f"down.{i}.block.")
                nk = nk.replace(f"down_blocks.{i}.downsamplers.0.conv",
                                f"down.{i}.downsample.conv")
            nk = nk.replace("mid_block.resnets.0.", "mid.block_1.")
            nk = nk.replace("mid_block.resnets.1.", "mid.block_2.")
            if "mid_block.attentions.0." in nk:
                for a, b in attn_map.items():
                    nk = nk.replace(f"mid_block.attentions.0.{a}.",
                                    f"mid.attn_1.{b}.")
            nk = nk.replace(".conv_shortcut.", ".nin_shortcut.")
        if k.startswith("decoder.mid_block.attentions.0."):
            for a, b in attn_map.items():
                nk = nk.replace(f"attentions.0.{a}.", f"attentions.0.{b}.")
        # the attention projections ship as [C, C] Linears; the blocks run
        # them as 1x1 convs
        if (("attn_1" in nk or "attentions.0" in nk)
                and nk.endswith(".weight")
                and not nk.endswith("norm.weight") and v.dim() == 2):
            v = v[:, :, None, None]
        out[nk] = v
    return out


def svd_vae_params_from_state_dict(sd: Mapping, enc_cfg: FluxVAEConfig,
                                   dec_cfg: TemporalDecoderConfig,
                                   dtype=torch.float32, device="cuda"
                                   ) -> Tuple[dict, Dict[str, list]]:
    """encoder.* through the image VAE's exact map, quant_conv, decoder.*
    through the generic published-naming map; the CompVis and the diffusers
    naming both. (params on `device`, coverage report), as JAX's."""
    from flexam_tpu_torch.io.checkpoints import _source
    from flexam_tpu_torch.io.convert import leaf
    dev = resolve_device(device)
    if any(k.startswith("encoder.down_blocks.") for k in sd):
        sd = _translate_diffusers_vae(sd, enc_cfg)
    enc_sd = {k: _source(sd, k)[0] for k in sd if k.startswith("encoder.")}
    enc, enc_rep = _fv.flux_vae_params_from_state_dict(enc_sd, enc_cfg,
                                                       dtype, dev)
    loaded = [p for p in enc_rep["loaded"] if p.startswith("encoder")]
    missed = [p for p in enc_rep["missed"] if p.startswith("encoder")]
    dec = _decoder_tree(dec_cfg, ParamDraw(None, dtype, dev))
    dl, dm, used = load_by_names(sd, dec, "decoder.", dtype, dev)
    loaded += dl
    missed += dm
    params = {"encoder": enc["encoder"], "decoder": dec}
    if "quant_conv.weight" in sd:
        params["quant_conv"] = {
            "w": leaf(_source(sd, "quant_conv.weight")[0], dev, dtype),
            "b": leaf(_source(sd, "quant_conv.bias")[0], dev, dtype)}
        loaded.append("quant_conv")
        used.update(("quant_conv.weight", "quant_conv.bias"))
    used.update(k for k in sd if k.startswith("encoder."))
    flat = flatten(dec)
    unused = [k for k in sd if k not in used and not k.startswith("decoder.")]
    unused += [k for k in sd if k.startswith("decoder.")
               and k not in used and k[8:] not in flat]
    return params, {"loaded": loaded, "missed": missed, "unused": unused}


def svd_vae_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """The CompVis-style file of a (encoder, quant_conv, temporal decoder)
    tree: JAX's naming, for `io.checkpoints.save_safetensors`."""
    enc_cfg = _encoder_cfg(params["encoder"])
    out = {k: v for k, v in _fv.flux_vae_state_dict(
        {"encoder": params["encoder"], "decoder": {}}, enc_cfg).items()
        if k.startswith("encoder.")}
    if "quant_conv" in params:
        out["quant_conv.weight"] = params["quant_conv"]["w"]
        out["quant_conv.bias"] = params["quant_conv"]["b"]
    out.update({f"decoder.{k}": v
                for k, v in flatten(params["decoder"]).items()})
    return out


def _encoder_cfg(enc: dict) -> FluxVAEConfig:
    """The encoder geometry of a tree (for its names)."""
    ch = enc["conv_in"]["w"].shape[0]
    mult = tuple(lv["block"][-1]["conv2"]["w"].shape[0] // ch
                 for lv in enc["down"])
    return FluxVAEConfig(ch=ch, ch_mult=mult,
                         num_res_blocks=len(enc["down"][0]["block"]),
                         z_channels=enc["conv_out"]["w"].shape[0] // 2)


def make_temporal_decode_fn(params: dict, dec_cfg: TemporalDecoderConfig,
                            dtype=torch.float32):
    """`decode_fn` for `DepthCrafterDenoiser`: scaled latents [T, z, h, w]
    -> [T, 3, H, W] float32."""
    from flexam_tpu_torch.io.convert import cast_floats
    dec = cast_floats(params["decoder"], dtype)

    def fn(z):
        with torch.no_grad():
            return temporal_decode(dec, dec_cfg, z.to(dtype)).float()
    return fn
