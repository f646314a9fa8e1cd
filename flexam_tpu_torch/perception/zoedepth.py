"""ZoeDepth (ZoeD_M12_N): metric depth for the `VideoToDepth` annotator.

Port of `flexam_tpu/perception/zoedepth.py` (which follows the vendored
`comfyui/annotator/zoe/` source), in torch ops on the caller's device (CUDA
unless the caller asks for the CPU), channels-last inside as in JAX:

  * the BEiT-L/16 backbone: cls token, per-block relative position bias
    (the trained 24x24 window's table resized to the runtime window, e.g.
    24x42 at 384x672), LayerScale, q/v-only qkv biases, taps at blocks
    [5, 11, 17, 23]. Its attention adds the bias to the logits, which is
    XLA work in JAX (einsum + softmax) and plain matmul + softmax here: no
    kernel of the port takes a bias;
  * the DPT neck: readout projection, per-tap resize (4x and 2x
    ConvTranspose, identity, a stride-2 conv), 3x3 scratch convs, four
    fusion blocks with align-corners upsampling, the output head;
  * the metric-bins head: softplus seed bins, attractors over four levels
    (the vendored `dist` defaults alpha 300, gamma 2, as JAX keeps them),
    the conditional log-binomial, depth = sum(p * bin centres);
  * `ZoeDepth.infer` with reflect padding and flip averaging, and
    `zoe_depth_video`, the depth registry's "zoe" backend.

Conv weights are torch's [O, I, kh, kw] and the ConvTranspose weights
[I, O, k, k] in both packages (JAX's `_conv_t` paints each input pixel's
unflipped k x k block, which is `conv_transpose2d` with stride k), so
`io.convert.from_jax_params` carries a JAX tree unchanged. Convolutions pad
as XLA's "SAME" does (the extra row and column of a stride-2 conv on an
even size go at the end). The loader maps the `ZoeD_M12_N.pt` names
exactly and reads the file with `torch.load(weights_only=True)` (JAX's:
False); `zoedepth_state_dict` writes a tree under those names.
"""

from __future__ import annotations

import functools
import math
import os
import sys
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flexam_tpu_torch.core.layers import layer_norm, linear
from flexam_tpu_torch.core.resize import resize
from flexam_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class ZoeDepthConfig:
    # BEiT-L/16 (timm beit_large_patch16_384 as used by DPT_BEiT_L_384)
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    train_window: Tuple[int, int] = (24, 24)   # 384/16
    hooks: Tuple[int, ...] = (5, 11, 17, 23)
    hook_features: Tuple[int, ...] = (256, 512, 1024, 1024)
    features: int = 256                        # scratch width
    head_features_2: int = 32
    # zoe head (config_zoedepth.json)
    n_bins: int = 64
    bin_embedding_dim: int = 128
    n_attractors: Tuple[int, ...] = (16, 8, 4, 1)
    attractor_alpha: float = 1000.0
    attractor_gamma: int = 2
    attractor_kind: str = "mean"
    attractor_type: str = "inv"
    min_depth: float = 1e-3
    max_depth: float = 10.0
    min_temp: float = 0.0212
    max_temp: float = 50.0
    img_size: Tuple[int, int] = (384, 512)


def tiny_zoe_config() -> ZoeDepthConfig:
    return ZoeDepthConfig(
        patch_size=16, embed_dim=32, depth=4, num_heads=2,
        train_window=(4, 4), hooks=(0, 1, 2, 3),
        hook_features=(8, 16, 32, 32), features=16, head_features_2=8,
        n_bins=8, bin_embedding_dim=16, n_attractors=(4, 2, 2, 1),
        img_size=(64, 64))


# ---------------------------------------------------------------------------
# init (random weights from a torch.Generator; JAX's shapes and scales)
# ---------------------------------------------------------------------------


def _lin_init(gen, din, dout, device, bias=True):
    w = torch.randn((dout, din), generator=gen, device=device) / math.sqrt(din)
    p = {"weight": w}
    if bias:
        p["bias"] = torch.zeros((dout,), device=device)
    return p


def _conv_init(gen, kh, kw, cin, cout, device, bias=True):
    w = torch.randn((cout, cin, kh, kw), generator=gen, device=device) \
        / math.sqrt(cin * kh * kw)
    p = {"weight": w}
    if bias:
        p["bias"] = torch.zeros((cout,), device=device)
    return p


def _ln_init(d, device):
    return {"weight": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def _beit_block_init(gen, cfg: ZoeDepthConfig, device):
    d = cfg.embed_dim
    hid = int(d * cfg.mlp_ratio)
    wh, ww = cfg.train_window
    n_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    return {
        "norm1": _ln_init(d, device),
        "qkv": _lin_init(gen, d, 3 * d, device, bias=False),
        "q_bias": torch.zeros((d,), device=device),
        "v_bias": torch.zeros((d,), device=device),
        "rel_pos_table": torch.randn((n_rel, cfg.num_heads), generator=gen,
                                     device=device) * 0.02,
        "proj": _lin_init(gen, d, d, device),
        "gamma_1": torch.full((d,), 0.1, device=device),
        "norm2": _ln_init(d, device),
        "fc1": _lin_init(gen, d, hid, device),
        "fc2": _lin_init(gen, hid, d, device),
        "gamma_2": torch.full((d,), 0.1, device=device),
    }


def _rcu_init(gen, f, device):
    return {"conv1": _conv_init(gen, 3, 3, f, f, device),
            "conv2": _conv_init(gen, 3, 3, f, f, device)}


def _fusion_init(gen, f, device):
    return {"out_conv": _conv_init(gen, 1, 1, f, f, device),
            "rcu1": _rcu_init(gen, f, device),
            "rcu2": _rcu_init(gen, f, device)}


def _mlp2conv_init(gen, cin, mid, cout, device):
    return {"conv1": _conv_init(gen, 1, 1, cin, mid, device),
            "conv2": _conv_init(gen, 1, 1, mid, cout, device)}


def zoedepth_init(gen: torch.Generator, cfg: ZoeDepthConfig,
                  device="cuda") -> dict:
    """A random tree with JAX's structure, shapes and scales, drawn on
    `device`."""
    device = resolve_device(device)
    d, f = cfg.embed_dim, cfg.features
    p: Dict = {
        "cls_token": torch.zeros((1, 1, d), device=device),
        "patch_embed": _conv_init(gen, cfg.patch_size, cfg.patch_size, 3, d,
                                  device),
        "blocks": [_beit_block_init(gen, cfg, device)
                   for _ in range(cfg.depth)],
    }
    post = []
    for i, hf in enumerate(cfg.hook_features):
        pp = {"readout": _lin_init(gen, 2 * d, d, device),
              "project": _conv_init(gen, 1, 1, d, hf, device)}
        if i in (0, 1):            # ConvTranspose 4x / 2x: [I, O, k, k]
            k = 4 if i == 0 else 2
            pp["resize"] = _conv_init(gen, k, k, hf, hf, device)
        elif i == 3:               # stride-2 conv
            pp["resize"] = _conv_init(gen, 3, 3, hf, hf, device)
        post.append(pp)
    p["act_postprocess"] = post
    p["layer_rn"] = [_conv_init(gen, 3, 3, hf, f, device, bias=False)
                     for hf in cfg.hook_features]
    p["refinenet"] = [_fusion_init(gen, f, device) for _ in range(4)]
    p["output_conv"] = {
        "conv1": _conv_init(gen, 3, 3, f, f // 2, device),
        "conv2": _conv_init(gen, 3, 3, f // 2, cfg.head_features_2, device),
        "conv3": _conv_init(gen, 1, 1, cfg.head_features_2, 1, device),
    }
    p["conv2"] = _conv_init(gen, 1, 1, f, f, device)
    p["seed_bin_regressor"] = _mlp2conv_init(gen, f, 256, cfg.n_bins, device)
    p["seed_projector"] = _mlp2conv_init(gen, f, 128, cfg.bin_embedding_dim,
                                         device)
    p["projectors"] = [_mlp2conv_init(gen, f, 128, cfg.bin_embedding_dim,
                                      device) for _ in range(4)]
    p["attractors"] = [_mlp2conv_init(gen, cfg.bin_embedding_dim, 128,
                                      cfg.n_attractors[i], device)
                       for i in range(4)]
    last_in = cfg.head_features_2 + 1
    bottleneck = (last_in + cfg.bin_embedding_dim) // 2
    p["clb"] = _mlp2conv_init(gen, last_in + cfg.bin_embedding_dim,
                              bottleneck, 4, device)
    return p


# ---------------------------------------------------------------------------
# primitives (channels-last, as in JAX)
# ---------------------------------------------------------------------------


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one axis: (before, after)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, p, stride=1, pad="SAME"):
    """x [B, H, W, C]; weight [O, I, kh, kw]. `pad`: "SAME" (XLA's),
    "VALID", or ((top, bottom), (left, right))."""
    w = p["weight"].to(x.dtype)
    kh, kw = w.shape[-2:]
    if pad == "SAME":
        pad = (_same_pads(x.shape[1], kh, stride),
               _same_pads(x.shape[2], kw, stride))
    elif pad == "VALID":
        pad = ((0, 0), (0, 0))
    (t, b), (l, r) = pad
    xc = x.permute(0, 3, 1, 2)
    if (t, b, l, r) != (0, 0, 0, 0):
        xc = F.pad(xc, (l, r, t, b))
    y = F.conv2d(xc, w, stride=stride).permute(0, 2, 3, 1)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def _conv_t(x, p, stride):
    """ConvTranspose2d with kernel = stride (the DPT resize convs): each
    input pixel paints an unflipped k x k block with weight [I, O, k, k],
    y[b, h*k+dh, w*k+dw, o] = sum_i x[b, h, w, i] W[i, o, dh, dw]."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), p["weight"].to(x.dtype),
                           stride=stride).permute(0, 2, 3, 1)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def _ln(x, p, eps=1e-6):
    return layer_norm(x, p["weight"], p["bias"], eps=eps)


def _gelu(x):
    return F.gelu(x)                               # the exact (erf) form


def resize_ac(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True over [..., H, W, C]
    (JAX's `resize_ac`: samples at linspace(0, H - 1, h), border cells
    owning their fractions in [0, 1])."""
    h, w = x.shape[-3], x.shape[-2]
    ho, wo = hw
    if (h, w) == (ho, wo):
        return x
    f32 = dict(dtype=torch.float32, device=x.device)
    ys = torch.linspace(0.0, h - 1.0, ho, **f32) if ho > 1 else \
        torch.zeros((1,), **f32)
    xs = torch.linspace(0.0, w - 1.0, wo, **f32) if wo > 1 else \
        torch.zeros((1,), **f32)
    y0 = torch.floor(ys).clamp(0, max(h - 2, 0))
    x0 = torch.floor(xs).clamp(0, max(w - 2, 0))
    fy = (ys - y0)[:, None, None].to(x.dtype)
    fx = (xs - x0)[None, :, None].to(x.dtype)
    y0, x0 = y0.long(), x0.long()
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    r0, r1 = x[..., y0, :, :], x[..., y1, :, :]
    a, b = r0[..., :, x0, :], r0[..., :, x1, :]
    c, d = r1[..., :, x0, :], r1[..., :, x1, :]
    return (a * (1 - fx) * (1 - fy) + b * fx * (1 - fy)
            + c * (1 - fx) * fy + d * fx * fy)


# ---------------------------------------------------------------------------
# BEiT backbone
# ---------------------------------------------------------------------------


def _gen_relative_position_index(wh: int, ww: int) -> np.ndarray:
    """timm `gen_relative_position_index`: [(N+1), (N+1)] int index into
    the bias table, the 3 trailing entries for the cls interactions."""
    num_rel = (2 * wh - 1) * (2 * ww - 1)
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    n = wh * ww
    idx = np.zeros((n + 1, n + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel + 2
    idx[0:, 0] = num_rel + 1
    idx[0, 0] = num_rel
    return idx


@functools.lru_cache(maxsize=None)
def _rel_pos_index(wh: int, ww: int, device) -> torch.Tensor:
    """`_gen_relative_position_index(wh, ww)` flattened on `device`, built
    once per (wh, ww) and device: every block of a forward, and every
    forward at one size, gathers with the same index (JAX's is a constant
    of its jitted forward)."""
    return torch.from_numpy(
        _gen_relative_position_index(wh, ww)).to(device).reshape(-1)


def _rel_pos_bias(table: torch.Tensor, cfg: ZoeDepthConfig,
                  window: Tuple[int, int]) -> torch.Tensor:
    """The trained window's bias table resized to the runtime window
    (`backbones/beit.py _get_rel_pos_bias`) -> [heads, N+1, N+1]."""
    owh, oww = cfg.train_window
    wh, ww = window
    oh, ow = 2 * owh - 1, 2 * oww - 1
    nh, nw = 2 * wh - 1, 2 * ww - 1
    sub = table[: oh * ow]
    if (nh, nw) != (oh, ow):
        # the vendored code reshapes (1, old_width, old_height, -1):
        # width-major, reproduced as JAX does; `jax.image.resize` bilinear
        grid = sub.reshape(ow, oh, -1).float()
        grid = resize(grid, (nh, nw, grid.shape[-1]), "bilinear")
        sub = grid.reshape(nh * nw, -1).to(table.dtype)
    full = torch.cat([sub, table[oh * ow:]], dim=0)
    idx = _rel_pos_index(wh, ww, table.device)
    n = wh * ww + 1
    return full[idx].reshape(n, n, -1).permute(2, 0, 1)


def _beit_block(p, x, bias, num_heads):
    """Pre-norm block; softmax(q k^T / sqrt(dh) + bias) v in fp32 logits."""
    b, n, d = x.shape
    dh = d // num_heads
    h = _ln(x, p["norm1"])
    qkv_bias = torch.cat([p["q_bias"], torch.zeros_like(p["q_bias"]),
                          p["v_bias"]]).to(h.dtype)
    qkv = torch.matmul(h, p["qkv"]["weight"].to(h.dtype).t()) + qkv_bias
    qkv = qkv.reshape(b, n, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                     # [B, H, N, dh]
    logits = torch.matmul((q * dh ** -0.5).float(),
                          k.float().transpose(-1, -2))
    logits = logits + bias[None].float()
    attn = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, d)
    x = x + p["gamma_1"].to(x.dtype) * linear(o, p["proj"])
    h = _ln(x, p["norm2"])
    h = linear(_gelu(linear(h, p["fc1"])), p["fc2"])
    return x + p["gamma_2"].to(x.dtype) * h


def _backbone(params, cfg: ZoeDepthConfig, x: torch.Tensor):
    """x [B, H, W, 3] midas-normalized -> the four taps [B, h_i, w_i,
    hf_i] after readout, projection and the resize convs."""
    b, hh, ww, _ = x.shape
    h0, w0 = hh // cfg.patch_size, ww // cfg.patch_size
    d = cfg.embed_dim
    tok = _conv(x, params["patch_embed"], stride=cfg.patch_size,
                pad="VALID").reshape(b, h0 * w0, d)
    cls = params["cls_token"].to(tok.dtype).expand(b, 1, d)
    tok = torch.cat([cls, tok], dim=1)
    taps = {}
    want = set(cfg.hooks)
    for i, bp in enumerate(params["blocks"]):
        bias = _rel_pos_bias(bp["rel_pos_table"], cfg, (h0, w0))
        tok = _beit_block(bp, tok, bias, cfg.num_heads)
        if i in want:
            taps[i] = tok
    feats = []
    for j, hook in enumerate(cfg.hooks):
        t = taps[hook]
        pp = params["act_postprocess"][j]
        f = torch.cat([t[:, 1:], t[:, :1].expand_as(t[:, 1:])], dim=-1)
        f = _gelu(linear(f, pp["readout"])).reshape(b, h0, w0, d)
        f = _conv(f, pp["project"])
        if j == 0:
            f = _conv_t(f, pp["resize"], 4)
        elif j == 1:
            f = _conv_t(f, pp["resize"], 2)
        elif j == 3:
            f = _conv(f, pp["resize"], stride=2)
        feats.append(f)
    return feats


def _rcu(p, x):
    out = _conv(F.relu(x), p["conv1"])
    out = _conv(F.relu(out), p["conv2"])
    return out + x


def _fusion(p, x, skip=None, size=None):
    if skip is not None:
        x = x + _rcu(p["rcu1"], skip)
    x = _rcu(p["rcu2"], x)
    if size is None:
        size = (x.shape[-3] * 2, x.shape[-2] * 2)
    return _conv(resize_ac(x, size), p["out_conv"])


def _identity(v):
    return v


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _mlp2conv(p, x, act=F.relu, final=F.relu):
    return final(_conv(act(_conv(x, p["conv1"])), p["conv2"]))


def _log_binom(n, k, eps=1e-7):
    """`dist_layers.py log_binom`, with (n - k) floored at eps as JAX's
    (its k = n entry then moves by eps log eps ~ 1.6e-6)."""
    n = n + eps
    k = k + eps
    nk = torch.clamp(n - k, min=eps)
    return n * torch.log(n) - k * torch.log(k) - nk * torch.log(nk)


@torch.no_grad()
def zoedepth_forward(params: dict, cfg: ZoeDepthConfig, x: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """x [B, H, W, 3] in 0..1 (H, W multiples of 32) -> {"metric_depth"
    [B, H, W, 1], "rel_depth" [B, H, W], "bin_centers", "probs"}."""
    x = (x - 0.5) / 0.5                         # PrepForMidas normalize
    feats = _backbone(params, cfg, x)
    rn = [_conv(fe, params["layer_rn"][i], pad=((1, 1), (1, 1)))
          for i, fe in enumerate(feats)]
    path4 = _fusion(params["refinenet"][3], rn[3], size=rn[2].shape[1:3])
    path3 = _fusion(params["refinenet"][2], path4, rn[2],
                    size=rn[1].shape[1:3])
    path2 = _fusion(params["refinenet"][1], path3, rn[1],
                    size=rn[0].shape[1:3])
    path1 = _fusion(params["refinenet"][0], path2, rn[0])

    oc = params["output_conv"]
    h1 = _conv(path1, oc["conv1"])
    h1 = resize_ac(h1, (h1.shape[1] * 2, h1.shape[2] * 2))
    out_conv_act = F.relu(_conv(h1, oc["conv2"]))        # the 32-ch tap
    rel = F.relu(_conv(out_conv_act, oc["conv3"]))[..., 0]

    # ---- the metric-bins head
    btl = _conv(rn[3], params["conv2"])
    b_prev = _mlp2conv(params["seed_bin_regressor"], btl, final=_softplus)
    prev_emb = _mlp2conv(params["seed_projector"], btl, final=_identity)
    for i, xb in enumerate((path4, path3, path2, path1)):
        emb = _mlp2conv(params["projectors"][i], xb, final=_identity)
        a_in = emb + resize_ac(prev_emb, emb.shape[1:3])
        A = _mlp2conv(params["attractors"][i], a_in, final=_softplus)
        bp = resize_ac(b_prev, emb.shape[1:3])
        dx = A[..., :, None] - bp[..., None, :]            # [.., na, nb]
        # the vendored AttractorLayer calls `dist(dx)` without its alpha /
        # gamma, so the scripted defaults 300 and 2 apply (JAX's note)
        alpha, gamma = 300.0, 2
        if cfg.attractor_type == "exp":
            delta = torch.exp(-alpha * dx.abs() ** gamma) * dx
        else:
            delta = dx / (1.0 + alpha * dx ** gamma)
        red = delta.mean(-2) if cfg.attractor_kind == "mean" else \
            delta.sum(-2)
        b_prev = bp + red
        prev_emb = emb

    last = torch.cat([out_conv_act,
                      resize_ac(rel[..., None], out_conv_act.shape[1:3])],
                     dim=-1)
    emb_up = resize_ac(prev_emb, last.shape[1:3])
    pt = _mlp2conv(params["clb"], torch.cat([last, emb_up], dim=-1),
                   act=_gelu, final=_softplus)
    p2 = pt[..., :2] + 1e-4
    prob = p2[..., 0] / (p2[..., 0] + p2[..., 1])
    t2 = pt[..., 2:] + 1e-4
    temp = t2[..., 0] / (t2[..., 0] + t2[..., 1])
    temp = (cfg.max_temp - cfg.min_temp) * temp + cfg.min_temp

    kk = torch.arange(cfg.n_bins, dtype=torch.float32, device=x.device)
    k1 = float(cfg.n_bins - 1)
    prob = prob.clamp(1e-4, 1.0)[..., None]
    one_m = (1.0 - prob).clamp(1e-4, 1.0)
    y = (_log_binom(torch.tensor(k1, device=x.device), kk)
         + kk * torch.log(prob) + (k1 - kk) * torch.log(one_m))
    probs = torch.softmax(y / temp[..., None], dim=-1)
    bc = resize_ac(b_prev, probs.shape[1:3])
    metric = (probs * bc).sum(-1, keepdim=True)
    return {"metric_depth": metric, "rel_depth": rel,
            "bin_centers": bc, "probs": probs}


# ---------------------------------------------------------------------------
# model wrapper: the reference's infer()
# ---------------------------------------------------------------------------


def _midas_size(h: int, w: int, cfg: ZoeDepthConfig) -> Tuple[int, int]:
    """PrepForMidas Resize: keep the aspect, a multiple of 32, "minimal";
    `np.round` rounds half to even, as in JAX."""
    th, tw = cfg.img_size
    sh, sw = th / h, tw / w
    if abs(1 - sw) < abs(1 - sh):
        sh = sw
    else:
        sw = sh
    nh = int(np.round(sh * h / 32) * 32)
    nw = int(np.round(sw * w / 32) * 32)
    return max(nh, 32), max(nw, 32)


class ZoeDepth:
    """The `ZoeDepth.build_from_config(...)` / `.infer(x)` surface
    (`annotator/nodes.py:171-178,195`); the params live on `device`."""

    def __init__(self, cfg: Optional[ZoeDepthConfig] = None, seed: int = 0,
                 params=None, device="cuda"):
        self.cfg = cfg or ZoeDepthConfig()
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = zoedepth_init(gen, self.cfg, self.device)
        self.params = params
        self.load_report = None
        self.load_ok = False

    def to(self, *a, **k):
        return self

    def eval(self):
        return self

    @staticmethod
    def build_from_config(config=None, device="cuda") -> "ZoeDepth":
        """FLEXAM_ZOE_CKPT's weights, else random ones with a warning."""
        ckpt = os.environ.get("FLEXAM_ZOE_CKPT")
        if ckpt and os.path.exists(ckpt):
            return load_zoedepth(ckpt, device=device)
        print("WARNING: no ZoeD_M12_N.pt (set FLEXAM_ZOE_CKPT) — "
              "random-weight ZoeDepth output is not meaningful depth",
              file=sys.stderr)
        return ZoeDepth(device=device)

    def _metric(self, x_bchw: np.ndarray) -> torch.Tensor:
        """[B, 3, H, W] -> metric depth [B, h', w'] at the midas size."""
        h, w = x_bchw.shape[2:]
        nh, nw = _midas_size(h, w, self.cfg)
        x = torch.from_numpy(np.ascontiguousarray(
            x_bchw.transpose(0, 2, 3, 1))).to(self.device, torch.float32)
        x = resize_ac(x, (nh, nw))
        return zoedepth_forward(self.params, self.cfg, x)[
            "metric_depth"][..., 0]

    def infer(self, x, pad_input: bool = True,
              with_flip_aug: bool = True) -> np.ndarray:
        """The reference `DepthModel.infer` (`depth_model.py`): reflect
        padding and horizontal-flip averaging; returns [B, 1, H, W]."""
        if torch.is_tensor(x):
            x = x.detach().cpu().numpy()
        x = np.asarray(x, np.float32)

        def one(xa):
            h, w = xa.shape[2:]
            ph = pw = 0
            if pad_input:
                ph = int(np.sqrt(h / 2) * 3)
                pw = int(np.sqrt(w / 2) * 3)
                xa = np.pad(xa, ((0, 0), (0, 0), (ph, ph), (pw, pw)),
                            mode="reflect")
            d = self._metric(xa)
            d = resize(d, (d.shape[0], xa.shape[2], xa.shape[3]),
                       "bicubic").cpu().numpy()
            if pad_input:
                d = d[:, ph:-ph if ph else None, pw:-pw if pw else None]
            return d

        out = one(x)
        if with_flip_aug:
            out = (out + one(x[..., ::-1])[..., ::-1]) / 2.0
        return out[:, None]


# ---------------------------------------------------------------------------
# the exact name map of ZoeD_M12_N.pt
# ---------------------------------------------------------------------------


def zoedepth_params_from_state_dict(sd, cfg: ZoeDepthConfig,
                                    device="cuda") -> dict:
    """The `torch.load(...)['model']` state dict of ZoeD_M12_N -> the
    port's tree on `device`. Names follow the vendored module hierarchy
    (`core.core.pretrained.model.*` timm BEiT, `core.core.pretrained.
    act_postprocessN.*`, `core.core.scratch.*`, the heads of
    `zoedepth_v1.py`); a missing name raises KeyError."""
    dev = resolve_device(device)

    def g(k):
        v = sd[k]
        v = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
        return v.to(dev, copy=True).float()

    def lin(prefix, bias=True):
        p = {"weight": g(prefix + ".weight")}
        if bias and prefix + ".bias" in sd:
            p["bias"] = g(prefix + ".bias")
        return p

    def pair(prefix, a="0", b="2"):
        return {"conv1": lin(f"{prefix}.{a}"), "conv2": lin(f"{prefix}.{b}")}

    mp = "core.core.pretrained.model."
    p: Dict = {"cls_token": g(mp + "cls_token"),
               "patch_embed": lin(mp + "patch_embed.proj"), "blocks": []}
    for i in range(cfg.depth):
        bp = f"{mp}blocks.{i}."
        p["blocks"].append({
            "norm1": lin(bp + "norm1"),
            "qkv": {"weight": g(bp + "attn.qkv.weight")},
            "q_bias": g(bp + "attn.q_bias"),
            "v_bias": g(bp + "attn.v_bias"),
            "rel_pos_table": g(bp + "attn.relative_position_bias_table"),
            "proj": lin(bp + "attn.proj"),
            "gamma_1": g(bp + "gamma_1"),
            "norm2": lin(bp + "norm2"),
            "fc1": lin(bp + "mlp.fc1"),
            "fc2": lin(bp + "mlp.fc2"),
            "gamma_2": g(bp + "gamma_2"),
        })
    pp = "core.core.pretrained."
    post = []
    for j in range(4):
        entry = {"readout": lin(f"{pp}act_postprocess{j + 1}.0.project.0"),
                 "project": lin(f"{pp}act_postprocess{j + 1}.3")}
        if j != 2:
            entry["resize"] = lin(f"{pp}act_postprocess{j + 1}.4")
        post.append(entry)
    p["act_postprocess"] = post
    sp = "core.core.scratch."
    p["layer_rn"] = [{"weight": g(f"{sp}layer{j + 1}_rn.weight")}
                     for j in range(4)]
    p["refinenet"] = []
    for j in range(4):
        rp = f"{sp}refinenet{j + 1}."
        p["refinenet"].append({
            "out_conv": lin(rp + "out_conv"),
            "rcu1": pair(rp + "resConfUnit1", "conv1", "conv2"),
            "rcu2": pair(rp + "resConfUnit2", "conv1", "conv2")})
    p["output_conv"] = {"conv1": lin(sp + "output_conv.0"),
                        "conv2": lin(sp + "output_conv.2"),
                        "conv3": lin(sp + "output_conv.4")}
    p["conv2"] = lin("conv2")
    p["seed_bin_regressor"] = pair("seed_bin_regressor._net")
    p["seed_projector"] = pair("seed_projector._net")
    p["projectors"] = [pair(f"projectors.{i}._net") for i in range(4)]
    p["attractors"] = [pair(f"attractors.{i}._net") for i in range(4)]
    p["clb"] = pair("conditional_log_binomial.mlp")
    return p


def zoedepth_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """The port's tree under ZoeD_M12_N's names (the inverse of
    `zoedepth_params_from_state_dict`), for files the loader reads."""
    sd: Dict[str, torch.Tensor] = {}

    def put(prefix, p):
        for k, v in p.items():
            sd[f"{prefix}.{k}"] = v

    def pair(prefix, p, a="0", b="2"):
        put(f"{prefix}.{a}", p["conv1"])
        put(f"{prefix}.{b}", p["conv2"])

    mp = "core.core.pretrained.model."
    sd[mp + "cls_token"] = params["cls_token"]
    put(mp + "patch_embed.proj", params["patch_embed"])
    for i, bp in enumerate(params["blocks"]):
        pre = f"{mp}blocks.{i}."
        for name, key in (("norm1", "norm1"), ("attn.qkv", "qkv"),
                          ("attn.proj", "proj"), ("norm2", "norm2"),
                          ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            put(pre + name, bp[key])
        for name, key in (("attn.q_bias", "q_bias"),
                          ("attn.v_bias", "v_bias"),
                          ("attn.relative_position_bias_table",
                           "rel_pos_table"),
                          ("gamma_1", "gamma_1"), ("gamma_2", "gamma_2")):
            sd[pre + name] = bp[key]
    pp = "core.core.pretrained."
    for j, e in enumerate(params["act_postprocess"]):
        put(f"{pp}act_postprocess{j + 1}.0.project.0", e["readout"])
        put(f"{pp}act_postprocess{j + 1}.3", e["project"])
        if "resize" in e:
            put(f"{pp}act_postprocess{j + 1}.4", e["resize"])
    sp = "core.core.scratch."
    for j in range(4):
        put(f"{sp}layer{j + 1}_rn", params["layer_rn"][j])
        r = params["refinenet"][j]
        put(f"{sp}refinenet{j + 1}.out_conv", r["out_conv"])
        for u in (1, 2):
            pair(f"{sp}refinenet{j + 1}.resConfUnit{u}", r[f"rcu{u}"],
                 "conv1", "conv2")
    for n, key in (("0", "conv1"), ("2", "conv2"), ("4", "conv3")):
        put(f"{sp}output_conv.{n}", params["output_conv"][key])
    put("conv2", params["conv2"])
    pair("seed_bin_regressor._net", params["seed_bin_regressor"])
    pair("seed_projector._net", params["seed_projector"])
    for i in range(4):
        pair(f"projectors.{i}._net", params["projectors"][i])
        pair(f"attractors.{i}._net", params["attractors"][i])
    pair("conditional_log_binomial.mlp", params["clb"])
    return sd


def _count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_count(v) for v in tree)
    return tree.numel()


def load_zoedepth(path: str, model: Optional[ZoeDepth] = None,
                  device="cuda") -> ZoeDepth:
    """Read `ZoeD_M12_N.pt` (a `model` dict, or the state dict itself)
    with `torch.load(weights_only=True)` before building anything, and map
    it onto `model` (a new one on `device` without it)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("model", obj)
    sd = {k: v for k, v in sd.items() if torch.is_tensor(v)}
    cfg = model.cfg if model is not None else ZoeDepthConfig()
    dev = model.device if model is not None else resolve_device(device)
    params = zoedepth_params_from_state_dict(sd, cfg, dev)
    if model is None:
        model = ZoeDepth(cfg, params=params, device=dev)
    model.params = params
    model.load_ok = True
    print(f"zoedepth: loaded {_count(params) / 1e6:.1f}M params "
          "(exact name map)")
    return model


def zoe_depth_video(video: np.ndarray, model: Optional[ZoeDepth] = None,
                    batch: int = 4, device="cuda") -> np.ndarray:
    """[T, H, W, 3] 0..1 -> [T, H, W] metric depth, `batch` frames a call;
    the depth registry's "zoe" backend (FLEXAM_ZOE_CKPT)."""
    model = model or ZoeDepth.build_from_config(device=device)
    v = np.asarray(video, np.float32)
    outs = []
    for i in range(0, v.shape[0], batch):
        chunk = v[i:i + batch].transpose(0, 3, 1, 2)
        outs.append(model.infer(chunk, pad_input=False,
                                with_flip_aug=False)[:, 0])
    return np.concatenate(outs, axis=0)
