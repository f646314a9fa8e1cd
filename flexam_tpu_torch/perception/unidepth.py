"""UniDepth V2: the monocular metric-depth estimator.

Port of `flexam_tpu/perception/unidepth.py` (which follows the vendored
reference source `comfyui/annotator/UniDepth/unidepth/` module by module),
in torch ops on the caller's device (CUDA unless the caller asks for the
CPU):

  * the DINOv2 ViT encoder: patch14 conv embed, cls + register tokens,
    position embeddings interpolated bicubically (Keys a = -0.5, as
    `jax.image.resize`, through `core.resize`), pre-norm blocks with
    LayerScale, the per-depth-slice outputs (`stacking_fn`);
  * the decoder: input / camera-token adapters, the camera head (2
    attention blocks over the projected cls tokens, pinhole fill), the ray
    grid, the depth head (fourier ray embedding, per-level camera-prompt
    cross-attention, ConvTranspose feature injection, ResUpsampleBil
    refinement, log-depth / confidence heads with align-corners
    upsampling);
  * `UniDepthV2.infer`: pad to the aspect-ratio bounds, resize into the
    pixel budget (multiple of 14), ImageNet normalization, resize back and
    crop, intrinsics rescale; `keys=("depth",)` is the video fast path;
  * `load_unidepth` / `load_unidepth_state_dict`: the exact name map of the
    HF `unidepth-v2-vitl14` state dict (`.safetensors` through
    `io/checkpoints.read_safetensors`, `.pth` / `.bin` through torch.load).

Every attention (the ViT's, the decoder's) goes through
`core.attention.exact_attention`, the plain exact version over query
chunks: the same function as JAX's inline einsum softmax, in bounded
memory. The GELU is the exact (erf) form. Conv weights are torch's
[O, I, kh, kw] (`io/convert.py` turns JAX's HWIO kernels into it); the
ConvTranspose weights stay [cin, cout, k, k] in both packages.
"""

from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flexam_tpu_torch.core.attention import exact_attention
from flexam_tpu_torch.core.layers import layer_norm, linear, linear_init
from flexam_tpu_torch.core.resize import resize
from flexam_tpu_torch.device import resolve_device

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class UniDepthV2Config:
    """Geometry of `unidepth-v2-vitl14` (encoder: DINOv2 ViT-L/14 with 4
    register tokens; decoder dims from `decoder.py:482-531`)."""
    # encoder
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    layer_scale_init: float = 1.0          # >0 => LayerScale params exist
    output_idx: Tuple[int, ...] = (5, 12, 18, 24)
    pretrain_img_size: int = 518           # pos-embed grid = 37x37
    use_encoder_norm: bool = False
    stacking_fn: str = "last"
    # decoder
    hidden_dim: int = 512
    dec_num_heads: int = 8
    expansion: int = 4
    dec_depths: Tuple[int, ...] = (2, 2, 2)   # ResUpsampleBil layers
    out_dim: int = 64
    kernel_size: int = 7
    layer_scale: float = 1.0
    # infer-time shape constraints (config.json "shape_constraints")
    pixels_min: int = 200_000
    pixels_max: int = 600_000
    ratio_bounds: Tuple[float, float] = (0.5, 2.5)
    compute: str = "bfloat16"      # forward dtype (fp32 accumulation in
                                   # norms/softmax; tests pin float32)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute == "bfloat16" else torch.float32

    @property
    def num_slices(self) -> int:
        return len(self.output_idx)


def _dec_dims(cfg: UniDepthV2Config):
    """current/next/output channel schedule of DepthHead
    (`decoder.py:166-198`)."""
    h = cfg.hidden_dim
    dims = []
    for i in range(len(cfg.dec_depths)):
        cur = min(h, 2 * h // (2 ** i))
        nxt = 2 * h // (2 ** (i + 1))
        dims.append((cur, nxt, max(nxt, cfg.out_dim)))
    return dims


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def _conv2d(x, p, stride=1, padding="SAME", reflect=0):
    """NHWC conv; weight [O, I, kh, kw]. SAME padding at stride 1 (odd
    kernels), VALID, or `reflect` pixels of reflection padding."""
    w = p["weight"].to(x.dtype)
    xc = x.permute(0, 3, 1, 2)
    if reflect:
        xc = F.pad(xc, (reflect,) * 4, mode="reflect")
        pad = 0
    else:
        pad = w.shape[-1] // 2 if padding == "SAME" else 0
    y = F.conv2d(xc, w, stride=stride, padding=pad).permute(0, 2, 3, 1)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def _conv_init(gen, kh, kw, cin, cout, device):
    return {"weight": torch.randn((cout, cin, kh, kw), generator=gen,
                                  device=device) * 0.02,
            "bias": torch.zeros((cout,), device=device)}


def _ln(x, p, eps=1e-5):
    return layer_norm(x, p["weight"], p["bias"], eps=eps)


def _ln_init(d, device):
    return {"weight": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def _gelu(x):
    return F.gelu(x)                               # torch nn.GELU default


def _leaky(x):
    return F.leaky_relu(x, 0.01)


def _resize_bilinear(x, hw, align_corners=False, antialias=False):
    """x [..., H, W, C] -> [..., h, w, C]; `jax.image.resize` bilinear
    (half-pixel centers), or align_corners=True sampling."""
    h, w = hw
    if x.shape[-3] == h and x.shape[-2] == w:
        return x
    if not align_corners:
        return resize(x, (*x.shape[:-3], h, w, x.shape[-1]), "bilinear",
                      antialias=antialias)
    # align_corners=True: out[i] samples in at i*(H-1)/(h-1)
    hi, wi = x.shape[-3], x.shape[-2]
    f32 = dict(dtype=torch.float32, device=x.device)
    ys = torch.arange(h, **f32) * (hi - 1) / max(h - 1, 1)
    xs = torch.arange(w, **f32) * (wi - 1) / max(w - 1, 1)
    y0 = torch.floor(ys).clamp(0, hi - 2)
    x0 = torch.floor(xs).clamp(0, wi - 2)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    y0, x0 = y0.long(), x0.long()
    rows0, rows1 = x[..., y0, :, :], x[..., y0 + 1, :, :]
    a, b = rows0[..., :, x0, :], rows0[..., :, x0 + 1, :]
    c, d = rows1[..., :, x0, :], rows1[..., :, x0 + 1, :]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx)


# ---------------------------------------------------------------------------
# DINOv2 encoder
# ---------------------------------------------------------------------------


def _vit_block_init(gen, cfg: UniDepthV2Config, device):
    d = cfg.embed_dim
    hid = int(d * cfg.mlp_ratio)
    p = {"norm1": _ln_init(d, device),
         "attn": {"qkv": linear_init(gen, d, 3 * d, device=device),
                  "proj": linear_init(gen, d, d, device=device)},
         "norm2": _ln_init(d, device),
         "mlp": {"fc1": linear_init(gen, d, hid, device=device),
                 "fc2": linear_init(gen, hid, d, device=device)}}
    if cfg.layer_scale_init:
        p["ls1"] = {"gamma": torch.full((d,), cfg.layer_scale_init,
                                        device=device)}
        p["ls2"] = {"gamma": torch.full((d,), cfg.layer_scale_init,
                                        device=device)}
    return p


def _vit_block(p, x, num_heads):
    """`metadinov2/block.py:85-112` eval path (pre-norm + LayerScale)."""
    b, n, c = x.shape
    dh = c // num_heads
    h = _ln(x, p["norm1"], eps=1e-6)
    qkv = linear(h, p["attn"]["qkv"]).reshape(b, n, 3, num_heads, dh)
    o = exact_attention(qkv[:, :, 0], qkv[:, :, 1],
                        qkv[:, :, 2]).reshape(b, n, c)
    o = linear(o, p["attn"]["proj"])
    if "ls1" in p:
        o = o * p["ls1"]["gamma"].to(o.dtype)
    x = x + o
    h = _ln(x, p["norm2"], eps=1e-6)
    h = linear(_gelu(linear(h, p["mlp"]["fc1"])), p["mlp"]["fc2"])
    if "ls2" in p:
        h = h * p["ls2"]["gamma"].to(h.dtype)
    return x + h


def encoder_init(gen, cfg: UniDepthV2Config, device):
    grid = cfg.pretrain_img_size // cfg.patch_size
    d = cfg.embed_dim
    p = {
        "cls_token": torch.zeros((1, 1, d), device=device),
        "pos_embed": torch.randn((1, grid * grid + 1, d), generator=gen,
                                 device=device) * 0.02,
        "register_tokens": torch.zeros(
            (1, max(1, cfg.num_register_tokens), d), device=device),
        "patch_embed": {"proj": _conv_init(gen, cfg.patch_size,
                                           cfg.patch_size, 3, d, device)},
        "blocks": [_vit_block_init(gen, cfg, device)
                   for _ in range(cfg.depth)],
    }
    if cfg.use_encoder_norm:
        p["norm"] = _ln_init(d, device)
    return p


def _interp_pos_embed(pos_embed, h0, w0):
    """`dinov2.py:267-303` bicubic grid interpolation (class token kept)."""
    n = pos_embed.shape[1] - 1
    m = int(math.sqrt(n))
    if h0 * w0 == n and h0 == w0:
        return pos_embed
    cls_pe = pos_embed[:, :1]
    patch_pe = pos_embed[:, 1:].reshape(1, m, m, -1).float()
    patch_pe = resize(patch_pe, (1, h0, w0, patch_pe.shape[-1]), "bicubic",
                      antialias=False)
    return torch.cat([cls_pe.float(), patch_pe.reshape(1, h0 * w0, -1)],
                     dim=1)


def encode_image(p, x, cfg: UniDepthV2Config):
    """x [B, H, W, 3] (normalized) -> (features list of [B, h, w, C] per
    encoder slice, cls tokens list of [B, 1, C]) — `dinov2.py:324-347` +
    the slice stacking of `unidepthv2.py:447-460`."""
    b, hh, ww, _ = x.shape
    h0, w0 = hh // cfg.patch_size, ww // cfg.patch_size
    d = cfg.embed_dim
    tok = _conv2d(x, p["patch_embed"]["proj"], stride=cfg.patch_size,
                  padding="VALID").reshape(b, h0 * w0, d)
    cls = p["cls_token"].to(tok.dtype).expand(b, 1, d)
    tok = torch.cat([cls, tok], dim=1)
    tok = tok + _interp_pos_embed(p["pos_embed"], h0, w0).to(tok.dtype)
    if cfg.num_register_tokens:
        reg = p["register_tokens"].to(tok.dtype).expand(
            b, cfg.num_register_tokens, d)
        tok = torch.cat([tok[:, :1], reg, tok[:, 1:]], dim=1)

    slices = list(zip((0,) + tuple(cfg.output_idx[:-1]), cfg.output_idx))
    skip = 1 + cfg.num_register_tokens

    def emit(o):
        if cfg.use_encoder_norm:
            o = _ln(o, p["norm"], eps=1e-5)
        clss.append(o[:, :1])
        feats.append(o[:, skip:].reshape(b, h0, w0, d))

    feats, clss = [], []
    if cfg.stacking_fn == "last":
        need = {j - 1 for _, j in slices}
        outs = {}
        for i, bp in enumerate(p["blocks"]):
            tok = _vit_block(bp, tok, cfg.num_heads)
            if i in need:
                outs[i] = tok
        for _, j in slices:
            emit(outs[j - 1])
        return feats, clss
    # general stacking (mean/max/first): keep the slice's outputs
    all_outs = []
    for bp in p["blocks"]:
        tok = _vit_block(bp, tok, cfg.num_heads)
        all_outs.append(tok)
    red = {"mean": lambda xs: sum(xs) / len(xs),
           "max": lambda xs: torch.stack(xs, -1).amax(-1),
           "first": lambda xs: xs[0]}[cfg.stacking_fn]
    for i, j in slices:
        emit(red(all_outs[i:j]))
    return feats, clss


# ---------------------------------------------------------------------------
# decoder building blocks
# ---------------------------------------------------------------------------


def _mlp_init(gen, d, expansion, device, out_dim=None):
    hid = int(d * expansion)
    return {"norm": _ln_init(d, device),
            "proj1": linear_init(gen, d, hid, device=device),
            "proj2": linear_init(gen, hid, out_dim or d, device=device)}


def _mlp(p, x):
    """`layers/mlp.py:29-35` (norm -> proj1 -> GELU -> proj2)."""
    return linear(_gelu(linear(_ln(x, p["norm"]), p["proj1"])), p["proj2"])


def _attn_block_init(gen, d, expansion, num_heads, layer_scale, device,
                     use_bias=True, context_dim=None):
    p = {"norm_attnx": _ln_init(d, device),
         "norm_attnctx": _ln_init(context_dim or d, device),
         "q": linear_init(gen, d, d, device=device, bias=use_bias),
         "kv": linear_init(gen, context_dim or d, 2 * d, device=device,
                           bias=use_bias),
         "out": linear_init(gen, d, d, device=device, bias=use_bias),
         "mlp": _mlp_init(gen, d, expansion, device)}
    if layer_scale > 0.0:
        p["ls1"] = {"gamma": torch.full((d,), layer_scale, device=device)}
        p["ls2"] = {"gamma": torch.full((d,), layer_scale, device=device)}
    return p


def _attn_block(p, x, num_heads, context=None, pos_embed=None):
    """`layers/attention.py` AttentionBlock (pre-norm cross/self attention
    with optional additive positional embedding on q and LayerScale)."""
    b, n, d = x.shape
    dh = d // num_heads
    ctx = x if context is None else context
    h = _ln(x, p["norm_attnx"])
    c = _ln(ctx, p["norm_attnctx"])
    kv = linear(c, p["kv"]).reshape(b, ctx.shape[1], 2, num_heads, dh)
    q = linear(h, p["q"]).reshape(b, n, num_heads, dh)
    if pos_embed is not None:
        q = q + pos_embed.reshape(b, n, num_heads, dh).to(q.dtype)
    o = exact_attention(q, kv[:, :, 0], kv[:, :, 1]).reshape(b, n, d)
    o = linear(o, p["out"])
    if "ls1" in p:
        o = o * p["ls1"]["gamma"].to(o.dtype)
    x = x + o
    m = _mlp(p["mlp"], x)
    if "ls2" in p:
        m = m * p["ls2"]["gamma"].to(m.dtype)
    return x + m


def _rcu_init(gen, d, kernel, device):
    return {"conv1": _conv_init(gen, kernel, kernel, d, d, device),
            "conv2": _conv_init(gen, kernel, kernel, d, d, device),
            "gamma": torch.ones((d,), device=device)}


def _rcu(p, x):
    """`layers/upsample.py ResidualConvUnit` (LeakyReLU pre-activation,
    zero padding, layer-scale gamma)."""
    out = _conv2d(_leaky(x), p["conv1"])
    out = _conv2d(_leaky(out), p["conv2"])
    return out * p["gamma"].to(out.dtype) + x


def _res_upsample_init(gen, d, out_dim, num_layers, kernel, device):
    return {"convs": [_rcu_init(gen, d, kernel, device)
                      for _ in range(num_layers)],
            "up": _conv_init(gen, 1, 1, d, out_dim, device)}


def _res_upsample(p, x):
    """`ResUpsampleBil` — RCU stack, 1x1 projection, bilinear x2."""
    for c in p["convs"]:
        x = _rcu(c, x)
    x = _conv2d(x, p["up"])
    return _resize_bilinear(x, (2 * x.shape[1], 2 * x.shape[2]))


def _conv_transpose_blocky(p, x):
    """ConvTranspose2d with kernel_size == stride == k (zero padding):
    a per-cell outer product scattered to a kxk block (`decoder.py:
    170-178`). Weight in torch layout [cin, cout, k, k]."""
    w = p["weight"]
    cin, cout, k, _ = w.shape
    b, h, ww, _ = x.shape
    y = torch.einsum("bhwc,cokl->bhkwlo", x, w.to(x.dtype))
    return y.reshape(b, h * k, ww * k, cout) + p["bias"].to(x.dtype)


def _fourier_features(x, dim, max_freq):
    """`utils/positional_embedding.py:218-255` with use_log=True,
    use_cos=False, cat_orig=False."""
    input_dim = x.shape[-1]
    num_bands = dim // input_dim
    scales = 2.0 ** torch.linspace(0.0, math.log2(max_freq), num_bands,
                                   device=x.device)
    ang = x[..., None] * scales * math.pi
    return torch.sin(ang).reshape(*x.shape[:-1], input_dim * num_bands)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def decoder_init(gen, cfg: UniDepthV2Config, device):
    hd = cfg.hidden_dim
    dims = _dec_dims(cfg)

    def ablock(ls):
        return _attn_block_init(gen, hd, cfg.expansion, cfg.dec_num_heads,
                                ls, device, use_bias=False)

    last_mid, last_out = dims[-1][1], dims[-1][2]
    return {
        "input_adapter": [linear_init(gen, cfg.embed_dim, hd, device=device)
                          for _ in range(cfg.num_slices)],
        "camera_token_adapter": [linear_init(gen, cfg.embed_dim, hd,
                                             device=device)
                                 for _ in range(cfg.num_slices)],
        "level_embeds": torch.eye(cfg.num_slices, hd, device=device),
        "camera_layer": {
            "latents_pos": torch.randn((1, 4, hd), generator=gen,
                                       device=device),
            "project": _mlp_init(gen, hd, 1, device, out_dim=hd),
            "aggregate1": ablock(cfg.layer_scale),
            "aggregate2": ablock(cfg.layer_scale),
            "out_pinhole": _mlp_init(gen, hd, 1, device, out_dim=1),
        },
        "depth_layer": {
            "to_latents": linear_init(gen, hd, hd, device=device),
            "prompt_camera": [ablock(-1.0) for _ in range(4)],
            "process_features": [
                {"weight": torch.randn(
                    (hd, dims[i][0], max(1, 2 * i), max(1, 2 * i)),
                    generator=gen, device=device) * 0.02,
                 "bias": torch.zeros((dims[i][0],), device=device)}
                for i in range(len(dims))],
            "ups": [_res_upsample_init(gen, dims[i][0], dims[i][2],
                                       cfg.dec_depths[i], cfg.kernel_size,
                                       device)
                    for i in range(len(dims))],
            "depth_mlp_last": {"norm": _ln_init(last_mid, device),
                               "proj": linear_init(gen, last_mid, last_out,
                                                   device=device)},
            "confidence_mlp": {"norm": _ln_init(last_mid, device),
                               "proj": linear_init(gen, last_mid, last_out,
                                                   device=device)},
            "to_depth_lr": _conv_init(gen, 3, 3, last_out, last_out // 2,
                                      device),
            "to_confidence_lr": _conv_init(gen, 3, 3, last_out,
                                           last_out // 2, device),
            "to_depth_hr": [_conv_init(gen, 3, 3, last_out // 2, 32, device),
                            _conv_init(gen, 1, 1, 32, 1, device)],
            "to_confidence_hr": [
                _conv_init(gen, 3, 3, last_out // 2, 32, device),
                _conv_init(gen, 1, 1, 32, 1, device)],
        },
    }


def _fill_intrinsics(x, hw):
    """`decoder.py:89-103`."""
    h, w = hw
    diag = (h ** 2 + w ** 2) ** 0.5
    corr = torch.tensor([0.7 * diag, 0.7 * diag, w, h], dtype=x.dtype,
                        device=x.device)
    out = torch.stack([torch.exp(x[:, 0]), torch.exp(x[:, 1]),
                       torch.sigmoid(x[:, 2]), torch.sigmoid(x[:, 3])], dim=1)
    return out * corr[None]


def _camera_head(p, cls_tokens, hw, num_heads):
    """`decoder.py:105-116` -> [B, 4] pinhole params (fx fy cx cy)."""
    tokens = _mlp(p["project"], cls_tokens)
    lp = p["latents_pos"].to(tokens.dtype).expand(tokens.shape)
    tokens = _attn_block(p["aggregate1"], tokens, num_heads, pos_embed=lp)
    tokens = _attn_block(p["aggregate2"], tokens, num_heads, pos_embed=lp)
    x = _mlp(p["out_pinhole"], tokens)[..., 0]
    return _fill_intrinsics(x, hw)


def _rays_from_intrinsics(intr, hw):
    """`decoder.py:384-404`: K^-1 @ half-pixel homogeneous grid,
    normalized. intr [B, 4] = fx fy cx cy -> rays [B, H*W, 3]."""
    h, w = hw
    f32 = dict(dtype=torch.float32, device=intr.device)
    gy, gx = torch.meshgrid(torch.arange(h, **f32) + 0.5,
                            torch.arange(w, **f32) + 0.5, indexing="ij")
    intr = intr.float()
    fx, fy, cx, cy = (intr[:, i, None, None] for i in range(4))
    rx = (gx[None] - cx) / fx
    ry = (gy[None] - cy) / fy
    rays = torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)
    rays = rays / torch.clamp(torch.linalg.vector_norm(rays, dim=-1,
                                                       keepdim=True),
                              min=1e-5)
    return rays.reshape(intr.shape[0], h * w, 3)


def _embed_rays(rays, shapes, original_shapes, hidden_dim):
    """`decoder.py:239-259`."""
    b = rays.shape[0]
    r = rays.reshape(b, *original_shapes, 3)
    r = _resize_bilinear(r, shapes, antialias=True)
    r = r.reshape(b, shapes[0] * shapes[1], 3)
    r = r / torch.clamp(torch.linalg.vector_norm(r, dim=-1, keepdim=True),
                        min=1e-4)
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    polar = torch.arccos(z)
    x_clip = torch.clamp(x.abs(), min=1e-3) * (2 * (x >= 0).to(x.dtype) - 1)
    azimuth = torch.atan2(y, x_clip)
    emb = torch.stack([polar, azimuth], dim=-1)
    return _fourier_features(emb, hidden_dim, max(max(shapes) // 2, 2))


def _head(p_lr, p_hr, x, original_shapes):
    x = _conv2d(x, p_lr, reflect=1)
    x = _resize_bilinear(x, original_shapes, align_corners=True)
    x = _conv2d(_leaky(_conv2d(x, p_hr[0], reflect=1)), p_hr[1])
    return x[..., 0]


def _depth_head(p, features, rays_hr, shapes, original_shapes,
                cfg: UniDepthV2Config):
    """`decoder.py:122-345` DepthHead forward."""
    h, w = shapes
    rays_emb = _embed_rays(rays_hr, shapes, original_shapes,
                           cfg.hidden_dim)
    cond = [_attn_block(p["prompt_camera"][i], f, cfg.dec_num_heads,
                        context=rays_emb.to(f.dtype))
            for i, f in enumerate(features)]
    b = cond[0].shape[0]
    latents = linear(cond[0], p["to_latents"]).reshape(b, h, w, -1)
    cond_maps = [c.reshape(b, h, w, -1) for c in cond]
    for i, up in enumerate(p["ups"]):
        latents = latents + _conv_transpose_blocky(
            p["process_features"][i], cond_maps[i + 1])
        latents = _res_upsample(up, latents)
    logdepth = linear(_ln(latents, p["depth_mlp_last"]["norm"]),
                      p["depth_mlp_last"]["proj"])
    conf = linear(_ln(latents, p["confidence_mlp"]["norm"]),
                  p["confidence_mlp"]["proj"])
    return (_head(p["to_depth_lr"], p["to_depth_hr"], logdepth,
                  original_shapes),
            _head(p["to_confidence_lr"], p["to_confidence_hr"], conf,
                  original_shapes))


def decode(p, feats, clss, image_hw, cfg: UniDepthV2Config,
           depth_only: bool = False):
    """`decoder.py:418-476` Decoder.forward (minus the dead sine/level
    embeds). feats: list of [B, h, w, C]; returns the output dict (only
    "depth" with `depth_only`)."""
    b, h, w, _ = feats[0].shape
    features = [linear(f.reshape(b, h * w, -1), p["input_adapter"][i])
                for i, f in enumerate(feats)]
    camera_tokens = [linear(c, p["camera_token_adapter"][i])
                     for i, c in enumerate(clss)]
    intr4 = _camera_head(p["camera_layer"], torch.cat(camera_tokens, dim=1),
                         image_hw, cfg.dec_num_heads)
    rays = _rays_from_intrinsics(intr4, image_hw)
    logdepth, logconf = _depth_head(p["depth_layer"], features, rays,
                                    (h, w), image_hw, cfg)
    radius = torch.exp(torch.clamp(logdepth, -8.0, 8.0) + 2.0)
    rays_hw = rays.reshape(b, *image_hw, 3)
    if depth_only:
        return {"depth": rays_hw[..., 2] * radius}
    points = rays_hw * radius[..., None]
    intrinsics = torch.eye(3, device=rays.device).repeat(b, 1, 1)
    intrinsics[:, 0, 0] = intr4[:, 0].float()
    intrinsics[:, 1, 1] = intr4[:, 1].float()
    intrinsics[:, 0, 2] = intr4[:, 2].float()
    intrinsics[:, 1, 2] = intr4[:, 3].float()
    return {"depth": points[..., 2], "points": points, "rays": rays_hw,
            "radius": radius, "intrinsics": intrinsics,
            "confidence": torch.exp(torch.clamp(logconf, -8.0, 8.0))}


# ---------------------------------------------------------------------------
# model wrapper (infer pre/post like `unidepthv2.py:246-336`)
# ---------------------------------------------------------------------------


def unidepth_init(gen, cfg: UniDepthV2Config, device="cuda"):
    device = resolve_device(device)
    return {"pixel_encoder": encoder_init(gen, cfg, device),
            "pixel_decoder": decoder_init(gen, cfg, device)}


@torch.no_grad()
def forward(params, x, image_hw, cfg: UniDepthV2Config,
            depth_only: bool = False):
    """x [B, H, W, 3] normalized, at `image_hw` -> the decoder's dict."""
    feats, clss = encode_image(params["pixel_encoder"], x.to(cfg.dtype), cfg)
    return decode(params["pixel_decoder"], feats, clss, image_hw, cfg,
                  depth_only)


def _get_paddings(hw, ratio_bounds):
    """`unidepthv2.py:38-57`."""
    h, w = hw
    ratio = w / h
    target = min(ratio_bounds[1], max(ratio_bounds[0], ratio))
    if ratio > target:
        hn = int(w / target)
        pt = (hn - h) // 2
        return (0, 0, pt, hn - h - pt), (hn, w)
    wn = int(h * target)
    pl = (wn - w) // 2
    return (pl, wn - w - pl, 0, 0), (h, wn)


def _get_resize(hw, pixels_range, mult=14):
    """`unidepthv2.py:60-77`."""
    h, w = hw
    n = h * w
    target = min(pixels_range[1], max(pixels_range[0], n))
    f = (target / n) ** 0.5
    nh = math.ceil(int(h * f) / mult) * mult
    nw = math.ceil(int(w * f) / mult) * mult
    return f, (nh, nw)


class UniDepthV2:
    """Drop-in for the reference call surface: `model.infer(rgb)` with rgb
    [B or T, 3, H, W] in 0..255 returns {"depth" [T,1,H,W], "points",
    "intrinsics", "confidence", "rays"} as numpy float32, what
    `predict_unidepth` consumes (`pipelines.py:1294-1304`). The params live
    on `device`."""

    def __init__(self, cfg: Optional[UniDepthV2Config] = None,
                 params=None, seed: int = 0, device="cuda"):
        self.cfg = cfg or UniDepthV2Config()
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = unidepth_init(gen, self.cfg, self.device)
        self.params = params
        self.resolution_level = 9     # like the reference default (max res)

    def to(self, *a, **k):
        return self

    def eval(self):
        return self

    def geometry(self, h: int, w: int):
        """(paddings (l, r, t, b), padded (H, W), resize factor, network
        input (H, W)) for an h x w frame: the pixel budget's slice that
        `resolution_level` picks (`unidepthv2.py:252-260`)."""
        cfg = self.cfg
        lo, hi = cfg.pixels_min, cfg.pixels_max
        interval = (hi - lo) / 10
        bounds = (self.resolution_level * interval + lo,
                  (self.resolution_level + 1) * interval + lo)
        pads, padded = _get_paddings((h, w), cfg.ratio_bounds)
        f, net_hw = _get_resize(padded, bounds, cfg.patch_size)
        return pads, padded, f, net_hw

    def infer(self, rgb, camera=None, normalize=True, keys=None):
        """keys=("depth",) is the video fast path (depth only, rounded to
        float16 as JAX ships it over its link: the rounding changes the
        values, so it stays); None returns the reference's full dict."""
        cfg = self.cfg
        if torch.is_tensor(rgb):
            rgb = rgb.detach().cpu().numpy()
        arr = np.asarray(rgb, np.float32)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.shape[1] == 3:
            arr = arr.transpose(0, 2, 3, 1)          # -> [B, H, W, 3]
        b, h, w, _ = arr.shape
        if normalize:
            # the reference divides by 255 unconditionally under
            # normalize=True (`unidepthv2.py:283-287`)
            arr = (arr / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        (pl, pr, pt, pb), (ph, pw), f, (nh, nw) = self.geometry(h, w)
        x = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
        x = _resize_bilinear(x, (nh, nw))
        depth_only = keys is not None and set(keys) == {"depth"}
        out = forward(self.params, x, (nh, nw), cfg, depth_only)

        def post(t):                                  # [B, nh, nw(, C)]
            t = t if t.dim() == 4 else t[..., None]
            t = _resize_bilinear(t, (ph, pw))
            return t[:, pt:ph - pb, pl:pw - pr].float()

        if depth_only:
            d = post(out["depth"])[..., 0].to(torch.float16)
            return {"depth": d[:, None].float().cpu().numpy()}

        depth = post(out["depth"]).cpu().numpy()      # [B, H, W, 1]
        conf = post(out["confidence"]).cpu().numpy()
        points = post(out["points"]).cpu().numpy()
        rays = post(out["rays"]).cpu().numpy()
        rays = rays / np.clip(np.linalg.norm(rays, axis=-1, keepdims=True),
                              1e-5, None)
        intr = out["intrinsics"].float().cpu().numpy().copy()
        # the reference divides by the single resize factor (:99-107)
        intr[:, 0, 0] /= f
        intr[:, 1, 1] /= f
        intr[:, 0, 2] = intr[:, 0, 2] / f - pl
        intr[:, 1, 2] = intr[:, 1, 2] / f - pt
        return {
            "depth": depth.transpose(0, 3, 1, 2),     # [B, 1, H, W]
            "confidence": conf.transpose(0, 3, 1, 2),
            "points": points.transpose(0, 3, 1, 2),
            "rays": rays.transpose(0, 3, 1, 2),
            "intrinsics": intr,
        }


def predict_depth_video(model: UniDepthV2, video: np.ndarray,
                        chunk: int = 32) -> np.ndarray:
    """`predict_unidepth` equivalent (`pipelines.py:1294-1304`): video
    [T, H, W, 3] 0..1 -> metric depth [T, H, W], `chunk` frames a call."""
    outs = []
    for i in range(0, video.shape[0], chunk):
        pred = model.infer(video[i:i + chunk].transpose(0, 3, 1, 2) * 255,
                           keys=("depth",))
        outs.append(pred["depth"][:, 0])
    return np.concatenate(outs, axis=0)


# device memory a chunk of frames may take for the ViT's attention
CHUNK_BUDGET_BYTES = 12 << 30


def video_chunk(model: UniDepthV2, h: int, w: int) -> int:
    """Frames a `predict_depth_video` call for h x w frames: as many as
    keep the ViT's attention temporaries within CHUNK_BUDGET_BYTES. A frame
    holds heads x queries x keys fp32 values three times over (the logits,
    their softmax, and the probabilities widened again for P.V), queries
    capped at the 2048 rows of `exact_attention`'s query chunk. Values do
    not depend on the chunk."""
    cfg = model.cfg
    nh, nw = model.geometry(h, w)[3]
    tokens = ((nh // cfg.patch_size) * (nw // cfg.patch_size) + 1
              + cfg.num_register_tokens)
    per_frame = 3 * cfg.num_heads * min(tokens, 2048) * tokens * 4
    return max(1, CHUNK_BUDGET_BYTES // per_frame)


# ---------------------------------------------------------------------------
# checkpoint loading (exact name map — the source is vendored)
# ---------------------------------------------------------------------------


def load_unidepth_state_dict(sd: dict, cfg: UniDepthV2Config,
                             device="cuda"):
    """torch state_dict (HF `unidepth-v2-vitl14`) -> params on `device`.
    Names follow the vendored modules exactly; a missing tensor raises
    KeyError so mismatches are loud. Conv kernels stay [O, I, kh, kw]."""
    dev = resolve_device(device)
    sd = {k.replace("module.", ""): v for k, v in sd.items()}

    def t(key):
        v = sd[key]
        v = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
        return v.to(dev, copy=True).float()

    def lin(prefix):
        p = {"weight": t(f"{prefix}.weight")}
        if f"{prefix}.bias" in sd:
            p["bias"] = t(f"{prefix}.bias")
        return p

    conv = lin

    def ln(prefix):
        return {"weight": t(f"{prefix}.weight"), "bias": t(f"{prefix}.bias")}

    def mlp(prefix):
        return {"norm": ln(f"{prefix}.norm"), "proj1": lin(f"{prefix}.proj1"),
                "proj2": lin(f"{prefix}.proj2")}

    def ablock(prefix, layer_scale):
        p = {"norm_attnx": ln(f"{prefix}.norm_attnx"),
             "norm_attnctx": ln(f"{prefix}.norm_attnctx"),
             "q": lin(f"{prefix}.q"), "kv": lin(f"{prefix}.kv"),
             "out": lin(f"{prefix}.out"), "mlp": mlp(f"{prefix}.mlp")}
        if layer_scale and f"{prefix}.ls1.gamma" in sd:
            p["ls1"] = {"gamma": t(f"{prefix}.ls1.gamma")}
            p["ls2"] = {"gamma": t(f"{prefix}.ls2.gamma")}
        return p

    reg = "pixel_encoder.register_tokens"
    enc = {
        "cls_token": t("pixel_encoder.cls_token"),
        "pos_embed": t("pixel_encoder.pos_embed"),
        "register_tokens": (t(reg) if reg in sd else torch.zeros(
            (1, max(1, cfg.num_register_tokens), cfg.embed_dim),
            device=dev)),
        "patch_embed": {"proj": conv("pixel_encoder.patch_embed.proj")},
        "blocks": [],
    }
    for i in range(cfg.depth):
        pre = f"pixel_encoder.blocks.{i}"
        if f"{pre}.norm1.weight" not in sd:        # block_chunks layout
            pre = f"pixel_encoder.blocks.0.{i}"
        bp = {"norm1": ln(f"{pre}.norm1"),
              "attn": {"qkv": lin(f"{pre}.attn.qkv"),
                       "proj": lin(f"{pre}.attn.proj")},
              "norm2": ln(f"{pre}.norm2"),
              "mlp": {"fc1": lin(f"{pre}.mlp.fc1"),
                      "fc2": lin(f"{pre}.mlp.fc2")}}
        if f"{pre}.ls1.gamma" in sd:
            bp["ls1"] = {"gamma": t(f"{pre}.ls1.gamma")}
            bp["ls2"] = {"gamma": t(f"{pre}.ls2.gamma")}
        enc["blocks"].append(bp)
    if "pixel_encoder.norm.weight" in sd and cfg.use_encoder_norm:
        enc["norm"] = ln("pixel_encoder.norm")

    d = "pixel_decoder"
    dl = f"{d}.depth_layer"
    dims = _dec_dims(cfg)
    last = len(dims) - 1
    dec = {
        "input_adapter": [lin(f"{d}.input_adapter.input_adapters.{i}")
                          for i in range(cfg.num_slices)],
        "camera_token_adapter": [
            lin(f"{d}.camera_token_adapter.input_adapters.{i}")
            for i in range(cfg.num_slices)],
        "level_embeds": t(f"{d}.level_embeds").reshape(cfg.num_slices,
                                                       cfg.hidden_dim),
        "camera_layer": {
            "latents_pos": t(f"{d}.camera_layer.latents_pos"),
            "project": mlp(f"{d}.camera_layer.project"),
            "aggregate1": ablock(f"{d}.camera_layer.aggregate1",
                                 cfg.layer_scale),
            "aggregate2": ablock(f"{d}.camera_layer.aggregate2",
                                 cfg.layer_scale),
            "out_pinhole": mlp(f"{d}.camera_layer.out_pinhole"),
        },
        "depth_layer": {
            "to_latents": lin(f"{dl}.to_latents"),
            "prompt_camera": [ablock(f"{dl}.prompt_camera.{i}.layers.0", 0.0)
                              for i in range(4)],
            "process_features": [
                {"weight": t(f"{dl}.process_features.{i}.weight"),
                 "bias": t(f"{dl}.process_features.{i}.bias")}
                for i in range(len(dims))],
            "ups": [],
            "depth_mlp_last": {"norm": ln(f"{dl}.depth_mlp.{last}.0"),
                               "proj": lin(f"{dl}.depth_mlp.{last}.1")},
            "confidence_mlp": {"norm": ln(f"{dl}.confidence_mlp.0"),
                               "proj": lin(f"{dl}.confidence_mlp.1")},
            "to_depth_lr": conv(f"{dl}.to_depth_lr"),
            "to_confidence_lr": conv(f"{dl}.to_confidence_lr"),
            "to_depth_hr": [conv(f"{dl}.to_depth_hr.0"),
                            conv(f"{dl}.to_depth_hr.2")],
            "to_confidence_hr": [conv(f"{dl}.to_confidence_hr.0"),
                                 conv(f"{dl}.to_confidence_hr.2")],
        },
    }
    for i in range(len(dims)):
        pre = f"{dl}.ups.{i}"
        dec["depth_layer"]["ups"].append({
            "convs": [{"conv1": conv(f"{pre}.convs.{j}.conv1"),
                       "conv2": conv(f"{pre}.convs.{j}.conv2"),
                       "gamma": t(f"{pre}.convs.{j}.gamma").reshape(-1)}
                      for j in range(cfg.dec_depths[i])],
            "up": conv(f"{pre}.up.0")})
    return {"pixel_encoder": enc, "pixel_decoder": dec}


def load_unidepth(path: str, cfg: Optional[UniDepthV2Config] = None,
                  device="cuda") -> UniDepthV2:
    """Load an HF snapshot dir or a raw torch .bin/.pth/.safetensors file
    of `unidepth-v2-vitl14` onto `device`."""
    from flexam_tpu_torch.io.checkpoints import read_safetensors

    cfg = cfg or UniDepthV2Config()
    if os.path.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin",
                     "unidepth_v2.pth"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
    if path.endswith(".safetensors"):
        sd = read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True,
                        mmap=True)
        if "model" in sd:
            sd = sd["model"]
        sd = {k: v for k, v in sd.items() if torch.is_tensor(v)}
    return UniDepthV2(cfg, params=load_unidepth_state_dict(sd, cfg, device),
                      device=device)


_BACKEND_CACHE: dict = {}


def _unidepth_backend(video: np.ndarray, model: Optional[UniDepthV2] = None,
                      chunk: Optional[int] = None, device="cuda",
                      **kw) -> np.ndarray:
    """Depth-registry backend: FLEXAM_UNIDEPTH_CKPT points at the
    checkpoint; without it a random-weight model runs (smoke only, warns).
    The model is cached per (checkpoint path, device): one demo run calls
    this from tracking and again from the repaint. `chunk` frames a call,
    by default as many as `video_chunk` lets memory hold."""
    if model is None:
        dev = resolve_device(device)
        ckpt = os.environ.get("FLEXAM_UNIDEPTH_CKPT")
        key = (ckpt if (ckpt and os.path.exists(ckpt)) else "__random__",
               str(dev))
        model = _BACKEND_CACHE.get(key)
        if model is None:
            if key[0] == "__random__":
                print("WARNING: FLEXAM_UNIDEPTH_CKPT not set — "
                      "random-weight UniDepthV2 (shapes only; depth "
                      "quality needs the trained checkpoint)",
                      file=sys.stderr)
                model = UniDepthV2(device=dev)
            else:
                model = load_unidepth(ckpt, device=dev)
            _BACKEND_CACHE[key] = model
    video = np.asarray(video, np.float32)
    if chunk is None:
        chunk = video_chunk(model, video.shape[1], video.shape[2])
    return predict_depth_video(model, video, chunk=chunk)
