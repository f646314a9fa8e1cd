"""Memory-bounded streamed VAE encode and decode (Wan2.2, 3.8).

Port of `flexam_tpu/models/vae_stream.py`. The whole-clip VAE of
`models/vae.py` holds full-resolution activations for every frame; a
512x896 clip of 97 frames and more no longer fits beside the DiT. Group
streaming runs G latent frames (decode) or 1+4k, then 4k, pixel frames
(encode) at a time and carries an explicit cache of each causal conv's
trailing input history at that layer's rate. Zero caches are the causal
padding, so the result equals the whole-clip path.

Cache contents per op:
  * CausalConv3d k_t=3: the last 2 input frames at that layer's rate;
  * decoder upsample3d time_conv: the last 2 frames of its input stream
    after frame 0 (the first output frame bypasses the conv);
  * encoder downsample3d time_conv: the last spatially resampled frame
    (the stride-2 windows stay aligned because groups are 1+4k / 4k frames).

The decode's host copy is uint8 RGB (`vae_decode_streamed_u8`) or, under
the pipeline's FLEXAM_DECODE_FETCH=yuv420, YUV 4:2:0 made on the device
(`vae_decode_streamed_yuv420`, half the bytes); `yuv420_to_rgb` (OpenCV's
I420 inverse, `utils/cv.py`) turns it back into RGB on the host.

Layout: channels-first [B, C, T, H, W] as in `models/vae.py`, so every
concatenation over time is on dim 2 (dim 1 in the channels-last JAX code)
and the cache shapes are (B, C, frames, H, W). Like the whole-clip VAE,
every op goes to cuDNN through torch; this module runs no kernel of its own.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from flexam_tpu_torch.config import VAEConfig
from flexam_tpu_torch.models.vae import (_silu, _stats, _upsample_nearest2x,
                                         attention_block, avg_down3d,
                                         causal_conv3d, channel_rms_norm,
                                         conv2d, dup_up3d, patchify,
                                         unpatchify)
from flexam_tpu_torch.utils.cv import yuv420_to_rgb  # noqa: F401 (JAX's name)


# ---------------------------------------------------------------------------
# Streaming primitive ops: (x, cache) -> (y, new_cache)
# ---------------------------------------------------------------------------

def _cconv_stream(x, p, cache):
    """Causal conv (k_t=3): consume 2 cached frames instead of zero pad."""
    ext = torch.cat([cache.to(x.dtype), x], dim=2)
    return causal_conv3d(ext, p, time_pad=(0, 0)), ext[:, :, -2:]


def _res_stream(x, p, caches: List):
    """Residual block with streamed convs; caches = [c_conv1, c_conv2]."""
    h = causal_conv3d(x, p["shortcut"]) if "shortcut" in p else x
    y = _silu(channel_rms_norm(x, p["norm1"]))
    y, c1 = _cconv_stream(y, p["conv1"], caches[0])
    y = _silu(channel_rms_norm(y, p["norm2"]))
    y, c2 = _cconv_stream(y, p["conv2"], caches[1])
    return y + h, [c1, c2]


def _upsample3d_stream(x, p, cache, first: bool):
    """Decoder temporal x2 + spatial x2 (see module docstring)."""
    head, tail = (x[:, :, :1], x[:, :, 1:]) if first else (None, x)
    ext = torch.cat([cache.to(x.dtype), tail], dim=2)
    y = causal_conv3d(ext, p["time_conv"], time_pad=(0, 0))  # [B, 2C, t, h, w]
    b, c2, tm, h, w = y.shape
    y = y.reshape(b, 2, c2 // 2, tm, h, w).permute(0, 2, 3, 1, 4, 5)
    y = y.reshape(b, c2 // 2, 2 * tm, h, w)
    if head is not None:
        y = torch.cat([head, y], dim=2)
    return conv2d(_upsample_nearest2x(y), p["resample_conv"]), ext[:, :, -2:]


def _downsample3d_stream(x, p, cache, first: bool):
    """Encoder spatial stride-2 conv, then temporal stride-2 valid conv."""
    x = conv2d(x, p["resample_conv"], stride=2, padding=((0, 1), (0, 1)))
    head = x[:, :, :1] if first else None
    ext = x if first else torch.cat([cache.to(x.dtype), x], dim=2)
    y = causal_conv3d(ext, p["time_conv"], stride=(2, 1, 1), time_pad=(0, 0))
    if head is not None:
        y = torch.cat([head, y], dim=2)
    return y, ext[:, :, -1:]


# ---------------------------------------------------------------------------
# Decoder groups
# ---------------------------------------------------------------------------

def _decoder_dims(cfg: VAEConfig):
    dim_mult = tuple(cfg.dim_mult)
    return [cfg.dec_dim * u for u in (dim_mult[-1],) + tuple(reversed(dim_mult))]


def _decoder_group(params, cfg: VAEConfig, x, caches, first: bool):
    """One latent group through the decoder; x: [B, z, G, h, w] (after
    conv2). Returns ([B, 12, ~4G, H/2, W/2], new caches)."""
    p = params["decoder"]
    dim_mult = tuple(cfg.dim_mult)
    temporal_up = tuple(reversed(cfg.temporal_downsample))
    nc: Dict = {"res": {}, "up": {}}

    def res(x, rp, key):
        y, nc["res"][key] = _res_stream(x, rp, caches["res"][key])
        return y

    x, nc["conv1"] = _cconv_stream(x, p["conv1"], caches["conv1"])
    x = res(x, p["middle"][0], "mid0")
    x = attention_block(x, p["middle"][1])
    x = res(x, p["middle"][2], "mid2")

    dims = _decoder_dims(cfg)
    for i in range(len(dim_mult)):
        x_in = x
        for j in range(cfg.num_res_blocks + 1):
            x = res(x, p["upsamples"][i]["res"][j], f"up{i}_{j}")
        if i != len(dim_mult) - 1:
            t_up = temporal_up[i] if i < len(temporal_up) else False
            if t_up:
                x, nc["up"][i] = _upsample3d_stream(
                    x, p["upsamples"][i]["up"], caches["up"][i], first)
            else:
                x = conv2d(_upsample_nearest2x(x),
                           p["upsamples"][i]["up"]["resample_conv"])
                nc["up"][i] = None
            x = x + dup_up3d(x_in, dims[i + 1], factor_t=2 if t_up else 1,
                             factor_s=2, first_chunk=first)
    x = _silu(channel_rms_norm(x, p["head_norm"]))
    x, nc["head"] = _cconv_stream(x, p["head_conv"], caches["head"])
    return x, nc


def _decoder_cache_shapes(cfg: VAEConfig, b, lh, lw, dtype, device):
    """Zero caches for the decoder stream (shapes at each layer's rate)."""
    dim_mult = tuple(cfg.dim_mult)
    temporal_up = tuple(reversed(cfg.temporal_downsample))
    dims = _decoder_dims(cfg)

    def z(c, h, w):
        return torch.zeros((b, c, 2, h, w), dtype=dtype, device=device)

    caches = {"res": {}, "up": {}, "conv1": z(cfg.latent_channels, lh, lw)}
    caches["res"]["mid0"] = [z(dims[0], lh, lw), z(dims[0], lh, lw)]
    caches["res"]["mid2"] = [z(dims[0], lh, lw), z(dims[0], lh, lw)]
    h, w = lh, lw
    for i in range(len(dim_mult)):
        for j in range(cfg.num_res_blocks + 1):
            c_in = dims[i] if j == 0 else dims[i + 1]
            caches["res"][f"up{i}_{j}"] = [z(c_in, h, w), z(dims[i + 1], h, w)]
        if i != len(dim_mult) - 1:
            t_up = temporal_up[i] if i < len(temporal_up) else False
            caches["up"][i] = z(dims[i + 1], h, w) if t_up else None
            h, w = h * 2, w * 2
    caches["head"] = z(dims[-1], h, w)
    return caches


# The streamed decode's peak above its start, in copies of the widest
# activation one latent frame makes (`decode_widest_bytes`): a base and so
# many more a latent frame of the group. The peaks measured on an H100 at
# 480x832 and 512x896, groups 1, 2 and 4 (`tools/decode_probe.py
# --ladder`), are 24.3, 38.4 and 69.5 such copies at both sizes; these
# constants lie 6-9 % above them.
DECODE_PEAK_BASE = 10.0
DECODE_PEAK_PER_FRAME = 16.0


def decode_widest_bytes(cfg: VAEConfig, b: int, lh: int, lw: int,
                        itemsize: int = 2) -> int:
    """Bytes of the largest activation one latent frame makes in the
    decoder at latent size lh x lw: the input of a spatial upsample's conv
    (the stage's channels at twice its height and width) or the last
    stage's output, over the pixel frames the latent frame becomes."""
    dims = _decoder_dims(cfg)
    temporal_up = tuple(reversed(cfg.temporal_downsample))
    frames, hw, widest = 1, lh * lw, 0
    for i in range(len(cfg.dim_mult)):
        if i == len(cfg.dim_mult) - 1:
            widest = max(widest, dims[i + 1] * frames * hw)
            break
        if i < len(temporal_up) and temporal_up[i]:
            frames *= 2
        hw *= 4
        widest = max(widest, dims[i + 1] * frames * hw)
    return b * widest * itemsize


def decode_group_peak_bytes(cfg: VAEConfig, b: int, group_size: int,
                            lh: int, lw: int, itemsize: int = 2) -> int:
    """Estimate of the device memory a streamed decode in groups of
    `group_size` latent frames takes above what was allocated when it
    started (module constants above)."""
    return int((DECODE_PEAK_BASE + DECODE_PEAK_PER_FRAME * group_size)
               * decode_widest_bytes(cfg, b, lh, lw, itemsize))


def _decode_groups(params: dict, cfg: VAEConfig, zlat: torch.Tensor,
                   group_size: int):
    """The streamed-decode loop: latent de-normalization, then the causal
    groups (the first at least 2 latent frames, the rest `group_size`).
    Yields pre-unpatchify pixel groups [B, 12, t, H/2, W/2]."""
    b, _, lt, lh, lw = zlat.shape
    mean, inv_std = _stats(params, zlat)
    x = causal_conv3d(zlat / inv_std + mean, params["conv2"])   # 1x1x1
    caches = _decoder_cache_shapes(cfg, b, lh, lw, zlat.dtype, zlat.device)
    g = min(group_size, lt)
    first_g = min(max(g, 2), lt)
    idx, first = 0, True
    while idx < lt:
        take = first_g if first else min(g, lt - idx)
        y, caches = _decoder_group(params, cfg, x[:, :, idx:idx + take],
                                   caches, first)
        yield y
        idx += take
        first = False


@torch.no_grad()
def vae_decode_streamed(params: dict, cfg: VAEConfig, zlat: torch.Tensor,
                        group_size: int = 4) -> torch.Tensor:
    """`vae_decode` with bounded memory: latents [B, z, T', H', W'] ->
    video [B, 3, T, 16H', 16W'] in [-1, 1]."""
    out = torch.cat(list(_decode_groups(params, cfg, zlat, group_size)), dim=2)
    return unpatchify(out, 2).clamp(-1.0, 1.0)


def _group_to_u8(y: torch.Tensor) -> torch.Tensor:
    """Pre-unpatchify decoder group -> uint8 pixels [B, 3, t, H, W]."""
    x = (unpatchify(y, 2).float().clamp(-1.0, 1.0) + 1.0) * (255.0 / 2.0)
    return torch.round(x).clamp(0, 255).to(torch.uint8)


@torch.no_grad()
def vae_decode_streamed_u8(params: dict, cfg: VAEConfig, zlat: torch.Tensor,
                           group_size: int = 4) -> torch.Tensor:
    """Streamed decode to uint8 video [B, 3, T, H, W] on the host: each
    group becomes uint8 on the device, then one copy brings the whole clip
    over. The same bytes as the uint8 of `vae_decode_streamed` (the JAX
    version returns [B, T, H, W, 3]; the port keeps its channels-first
    layout)."""
    u8 = [_group_to_u8(y) for y in _decode_groups(params, cfg, zlat,
                                                   group_size)]
    return torch.cat(u8, dim=2).cpu()


def _group_to_yuv420(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-unpatchify decoder group -> limited-range BT.601 YUV 4:2:0
    uint8 (Y [B, t, H, W], UV planar [B, t, 2, H/2, W/2]): JAX's matrix,
    its 2x2 chroma mean and its rounding (half to even). Limited range is
    what a yuv420p encoder takes and what `yuv420_to_rgb` inverts."""
    rgb = (unpatchify(y, 2).float().clamp(-1.0, 1.0) + 1.0) * (255.0 / 2.0)
    r, g, b = rgb.unbind(1)                           # [B, t, H, W] each
    luma = 16.0 + 0.256788 * r + 0.504129 * g + 0.097906 * b
    u = 128.0 - 0.148223 * r - 0.290993 * g + 0.439216 * b
    v = 128.0 + 0.439216 * r - 0.367788 * g - 0.071427 * b
    uv = torch.stack([u, v], dim=2)                   # [B, t, 2, H, W]
    bb, t, _, h, w = uv.shape
    uv = uv.view(bb, t, 2, h // 2, 2, w // 2, 2).mean(dim=(4, 6))

    def to_u8(x):
        return torch.round(x).clamp(0, 255).to(torch.uint8)
    return to_u8(luma), to_u8(uv)


@torch.no_grad()
def vae_decode_streamed_yuv420(params: dict, cfg: VAEConfig,
                               zlat: torch.Tensor, group_size: int = 4
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streamed decode fetching YUV 4:2:0 in place of RGB: host uint8
    (Y [B, T, H, W], UV planar [B, T, 2, H/2, W/2]), 1.5 bytes a pixel
    against the RGB path's 3. Chroma is subsampled on the device, so the
    result is not the RGB path's bytes; a yuv420p encoder discards the
    same chroma. `yuv420_to_rgb` turns it back into RGB."""
    ys, uvs = [], []
    for y in _decode_groups(params, cfg, zlat, group_size):
        luma, uv = _group_to_yuv420(y)
        ys.append(luma)
        uvs.append(uv)
    return torch.cat(ys, dim=1).cpu(), torch.cat(uvs, dim=1).cpu()


# ---------------------------------------------------------------------------
# Encoder groups
# ---------------------------------------------------------------------------

def _encoder_dims(cfg: VAEConfig):
    return [cfg.c_dim * u for u in (1,) + tuple(cfg.dim_mult)]


def _encoder_group(params, cfg: VAEConfig, x, caches, first: bool):
    """One pixel group through the encoder; x: [B, 12, g, H/2, W/2] (after
    patchify), g = 1+4k for the first group, 4k after."""
    p = params["encoder"]
    dim_mult = tuple(cfg.dim_mult)
    nc: Dict = {"res": {}, "down": {}}

    def res(x, rp, key):
        y, nc["res"][key] = _res_stream(x, rp, caches["res"][key])
        return y

    x, nc["conv1"] = _cconv_stream(x, p["conv1"], caches["conv1"])
    dims = _encoder_dims(cfg)
    for i in range(len(dim_mult)):
        x_in = x
        for j in range(cfg.num_res_blocks):
            x = res(x, p["downsamples"][i]["res"][j], f"down{i}_{j}")
        down_flag = i != len(dim_mult) - 1
        t_down = (cfg.temporal_downsample[i]
                  if i < len(cfg.temporal_downsample) else False)
        if down_flag:
            if t_down:
                x, nc["down"][i] = _downsample3d_stream(
                    x, p["downsamples"][i]["down"], caches["down"][i], first)
            else:
                x = conv2d(x, p["downsamples"][i]["down"]["resample_conv"],
                           stride=2, padding=((0, 1), (0, 1)))
                nc["down"][i] = None
        x = x + avg_down3d(x_in, dims[i + 1], factor_t=2 if t_down else 1,
                           factor_s=2 if down_flag else 1)
    x = res(x, p["middle"][0], "mid0")
    x = attention_block(x, p["middle"][1])
    x = res(x, p["middle"][2], "mid2")
    x = _silu(channel_rms_norm(x, p["head_norm"]))
    x, nc["head"] = _cconv_stream(x, p["head_conv"], caches["head"])
    return x, nc


def _encoder_cache_shapes(cfg: VAEConfig, b, h2, w2, dtype, device):
    dim_mult = tuple(cfg.dim_mult)
    dims = _encoder_dims(cfg)

    def z(c, t, h, w):
        return torch.zeros((b, c, t, h, w), dtype=dtype, device=device)

    caches = {"res": {}, "down": {}, "conv1": z(12, 2, h2, w2)}
    h, w = h2, w2
    for i in range(len(dim_mult)):
        for j in range(cfg.num_res_blocks):
            c_in = dims[i] if j == 0 else dims[i + 1]
            caches["res"][f"down{i}_{j}"] = [z(c_in, 2, h, w),
                                             z(dims[i + 1], 2, h, w)]
        t_down = (cfg.temporal_downsample[i]
                  if i < len(cfg.temporal_downsample) else False)
        if i != len(dim_mult) - 1:
            h, w = h // 2, w // 2
            caches["down"][i] = z(dims[i + 1], 1, h, w) if t_down else None
    mid = dims[-1]
    caches["res"]["mid0"] = [z(mid, 2, h, w), z(mid, 2, h, w)]
    caches["res"]["mid2"] = [z(mid, 2, h, w), z(mid, 2, h, w)]
    caches["head"] = z(mid, 2, h, w)
    return caches


@torch.no_grad()
def vae_encode_stream_fn(params: dict, cfg: VAEConfig,
                         frame_fn: Callable[[int, int], torch.Tensor],
                         num_frames: int, b: int = 1, group_size: int = 8
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streamed encode from a frame producer: `frame_fn(start, count)`
    returns pixel frames [B, 3, count, H, W] in [-1, 1], so the full clip
    need not exist at once. Returns (mu, log_var), each [B, z, T', H/16,
    W/16], mu normalized by the per-channel stats."""
    g = max(4, (group_size // 4) * 4)
    caches = None
    outs = []
    idx, first = 0, True
    while idx < num_frames:
        take = min(g + 1, num_frames) if first else min(g, num_frames - idx)
        x = patchify(frame_fn(idx, take), 2)
        if caches is None:
            caches = _encoder_cache_shapes(cfg, b, x.shape[3], x.shape[4],
                                           x.dtype, x.device)
        y, caches = _encoder_group(params, cfg, x, caches, first)
        outs.append(y)
        idx += take
        first = False
    out = causal_conv3d(torch.cat(outs, dim=2), params["conv1"])   # 1x1x1
    mu, log_var = out.chunk(2, dim=1)
    mean, inv_std = _stats(params, mu)
    return (mu - mean) * inv_std, log_var


def vae_encode_streamed(params: dict, cfg: VAEConfig, video: torch.Tensor,
                        group_size: int = 8
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`vae_encode` with bounded memory. video: [B, 3, T, H, W] in [-1, 1],
    T = 1+4k; group_size in pixel frames (rounded to 4k; the first group
    takes one frame more)."""
    return vae_encode_stream_fn(params, cfg,
                                lambda a, n: video[:, :, a:a + n],
                                video.shape[2], b=video.shape[0],
                                group_size=group_size)


def vae_encode_mode_streamed(params: dict, cfg: VAEConfig, video: torch.Tensor,
                             group_size: int = 8) -> torch.Tensor:
    """Deterministic streamed encode (the posterior mode)."""
    return vae_encode_streamed(params, cfg, video, group_size)[0]
