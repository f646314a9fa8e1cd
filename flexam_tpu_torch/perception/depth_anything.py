"""Depth-Anything-V2 (Large): relative depth for the repaint and the
`VideoToDepth` annotator.

Port of `flexam_tpu/perception/depth_anything.py`, in torch ops on the
caller's device (CUDA unless the caller asks for the CPU):

  * the DINOv2 ViT-L/14 encoder of `perception/unidepth.py`
    (`encoder_init` / `encode_image`) with DAv2's flags: no register
    tokens, LayerScale, the final norm on the taps at layers 4/11/17/23,
    `stacking_fn="last"`. Its position embedding (a 37x37 grid) is
    resized bicubically to the runtime grid, which need not be square:
    37x65 for a 512x896 frame (518x910 in, 2,405 patches). Its attention
    (head dim 64) is `core.attention.exact_attention`, counted in
    `exact_calls`, as UniDepth's;
  * the DPT head: per-tap 1x1 projections, 4x / 2x ConvTranspose,
    identity and a stride-2 conv, 3x3 scratch convs, the four fusion
    blocks of `perception/zoedepth.py` (`_rcu` / `_fusion`), and the
    3x3 -> resize -> 3x3 -> 1x1 output head;
  * `dav2_infer_video`: the lower-bound resize to a multiple of 14
    (OpenCV's INTER_CUBIC, `utils/media.resize_frames_cubic`), ImageNet
    normalization, and OpenCV's INTER_LINEAR back to the input size
    (`resize_frames_linear`);
  * `load_dav2`: the name map of the original-release
    `depth_anything_v2_vitl.pth` (`pretrained.*` / `depth_head.*`),
    coverage-gated (strict) through `io/verify_load.check_mapping`;
    `dav2_state_dict` writes a tree under those names.

JAX computes DAv2 in float32; so does the port. Conv weights are torch's
[O, I, kh, kw] (the encoder's patch embedding is HWIO in JAX's tree, which
`io.convert.from_jax_params` turns round; the head's convs are torch
layout in both), the ConvTranspose weights [I, O, k, k].
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flexam_tpu_torch.device import resolve_device
from flexam_tpu_torch.perception.unidepth import (IMAGENET_MEAN,
                                                  IMAGENET_STD,
                                                  UniDepthV2Config,
                                                  encode_image, encoder_init)
from flexam_tpu_torch.perception.zoedepth import (_conv, _conv_init, _conv_t,
                                                  _fusion, _fusion_init,
                                                  resize_ac)


@dataclass(frozen=True)
class DAv2Config:
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    patch_size: int = 14
    # intermediate_layer_idx["vitl"] = [4, 11, 17, 23] (0-based) -> the
    # 1-based slice ends of encode_image's output_idx
    output_idx: Tuple[int, ...] = (5, 12, 18, 24)
    features: int = 256
    out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    input_size: int = 518            # lower-bound resize, multiple of 14

    def encoder_cfg(self) -> UniDepthV2Config:
        return UniDepthV2Config(
            patch_size=self.patch_size, embed_dim=self.embed_dim,
            depth=self.depth, num_heads=self.num_heads,
            num_register_tokens=0, layer_scale_init=1.0,
            output_idx=self.output_idx, use_encoder_norm=True,
            stacking_fn="last")


def tiny_dav2_config() -> DAv2Config:
    return DAv2Config(embed_dim=32, depth=4, num_heads=2,
                      output_idx=(1, 2, 3, 4), features=16,
                      out_channels=(8, 16, 32, 32), input_size=42)


def dav2_init(gen: torch.Generator, cfg: DAv2Config, device="cuda") -> dict:
    """A random tree with JAX's structure and shapes, on `device`."""
    device = resolve_device(device)
    enc = encoder_init(gen, cfg.encoder_cfg(), device)
    f, oc = cfg.features, cfg.out_channels

    def convt(k, c):               # ConvTranspose2d layout [I, O, k, k]
        return {"weight": torch.randn((c, c, k, k), generator=gen,
                                      device=device) * 0.02,
                "bias": torch.zeros((c,), device=device)}

    head = {
        "projects": [_conv_init(gen, 1, 1, cfg.embed_dim, oc[i], device)
                     for i in range(4)],
        "resize0": convt(4, oc[0]),
        "resize1": convt(2, oc[1]),
        "resize3": _conv_init(gen, 3, 3, oc[3], oc[3], device),
        "layer_rn": [_conv_init(gen, 3, 3, oc[i], f, device, bias=False)
                     for i in range(4)],
        "refinenet": [_fusion_init(gen, f, device) for _ in range(4)],
        "out_conv1": _conv_init(gen, 3, 3, f, f // 2, device),
        "out_conv2a": _conv_init(gen, 3, 3, f // 2, 32, device),
        "out_conv2b": _conv_init(gen, 1, 1, 32, 1, device),
    }
    return {"encoder": enc, "head": head}


@torch.no_grad()
def dav2_forward(params: dict, x: torch.Tensor, cfg: DAv2Config
                 ) -> torch.Tensor:
    """x [B, H, W, 3] ImageNet-normalized, H and W multiples of the patch
    -> relative depth [B, H, W] (larger = nearer)."""
    b, hh, ww, _ = x.shape
    ph, pw = hh // cfg.patch_size, ww // cfg.patch_size
    feats, _ = encode_image(params["encoder"], x, cfg.encoder_cfg())
    head = params["head"]
    outs = []
    for i, ft in enumerate(feats):
        y = _conv(ft, head["projects"][i])
        if i == 0:
            y = _conv_t(y, head["resize0"], 4)
        elif i == 1:
            y = _conv_t(y, head["resize1"], 2)
        elif i == 3:
            y = _conv(y, head["resize3"], stride=2)
        outs.append(_conv(y, head["layer_rn"][i]))
    l1, l2, l3, l4 = outs
    p4 = _fusion(head["refinenet"][3], l4, size=l3.shape[1:3])
    p3 = _fusion(head["refinenet"][2], p4, skip=l3, size=l2.shape[1:3])
    p2 = _fusion(head["refinenet"][1], p3, skip=l2, size=l1.shape[1:3])
    p1 = _fusion(head["refinenet"][0], p2, skip=l1,
                 size=(l1.shape[1] * 2, l1.shape[2] * 2))
    y = _conv(p1, head["out_conv1"])
    y = resize_ac(y, (ph * cfg.patch_size, pw * cfg.patch_size))
    y = F.relu(_conv(y, head["out_conv2a"]))
    y = F.relu(_conv(y, head["out_conv2b"]))
    return y[..., 0]


# ---------------------------------------------------------------------------
# preprocessing and the video driver
# ---------------------------------------------------------------------------


def _lower_bound_size(h: int, w: int, target: int, mult: int
                      ) -> Tuple[int, int]:
    """DAv2's Resize(lower_bound, ensure_multiple_of=14): scale so the
    smaller side reaches >= target, then round each side up to the
    multiple (512x896 -> 518x910)."""
    scale = target / min(h, w)

    def rnd(v):
        return int(np.ceil(v / mult) * mult)

    return max(rnd(h * scale), target), max(rnd(w * scale), target)


def dav2_infer_video(params: dict, video: np.ndarray,
                     cfg: DAv2Config = DAv2Config(),
                     batch: int = 8) -> np.ndarray:
    """video [T, H, W, 3] float 0..1 -> relative depth [T, H, W] (resized
    back to the input geometry, the model's raw scale), `batch` frames a
    forward, on the device that holds `params`."""
    from flexam_tpu_torch.utils.media import (resize_frames_cubic,
                                              resize_frames_linear)
    dev = params["head"]["out_conv2b"]["weight"].device
    v = np.asarray(video, np.float32)
    t, h, w, _ = v.shape
    rh, rw = _lower_bound_size(h, w, cfg.input_size, cfg.patch_size)
    xs = resize_frames_cubic(v, (rh, rw))
    xs = (xs - IMAGENET_MEAN) / IMAGENET_STD
    outs = []
    for s in range(0, t, batch):
        x = torch.from_numpy(np.ascontiguousarray(xs[s:s + batch])).to(
            dev, torch.float32)
        outs.append(dav2_forward(params, x, cfg).cpu().numpy())
    d = np.concatenate(outs, 0).astype(np.float32)
    return resize_frames_linear(d[..., None], (h, w))[..., 0]


def _dav2_backend(video: np.ndarray, device="cuda", **kw) -> np.ndarray:
    """The depth registry's "dav2" / "dav": FLEXAM_DAV2_CKPT's weights
    (coverage-gated) on `device`, depth in the registry's bigger = farther
    convention (DAv2 predicts a disparity-like value, so 1 / it)."""
    params, cfg = load_dav2(os.environ["FLEXAM_DAV2_CKPT"], device=device)
    rel = dav2_infer_video(params, video, cfg)
    return 1.0 / np.maximum(rel, 1e-4)


# ---------------------------------------------------------------------------
# checkpoint loader (original-release naming: pretrained.* / depth_head.*)
# ---------------------------------------------------------------------------


def _release_names(params: dict):
    """(name, (subtree, key)) of every tensor the release file holds, in
    the loader's order."""
    enc, head = params["encoder"], params["head"]

    def conv(name, p):
        return [(name + ".weight", (p, "weight")),
                (name + ".bias", (p, "bias"))]

    out = conv("pretrained.patch_embed.proj", enc["patch_embed"]["proj"])
    out += [("pretrained.cls_token", (enc, "cls_token")),
            ("pretrained.pos_embed", (enc, "pos_embed"))]
    out += conv("pretrained.norm", enc["norm"])
    for i, bp in enumerate(enc["blocks"]):
        pre = f"pretrained.blocks.{i}."
        out += conv(pre + "norm1", bp["norm1"]) + conv(pre + "norm2",
                                                       bp["norm2"])
        out += conv(pre + "attn.qkv", bp["attn"]["qkv"])
        out += conv(pre + "attn.proj", bp["attn"]["proj"])
        out += conv(pre + "mlp.fc1", bp["mlp"]["fc1"])
        out += conv(pre + "mlp.fc2", bp["mlp"]["fc2"])
        out += [(pre + "ls1.gamma", (bp["ls1"], "gamma")),
                (pre + "ls2.gamma", (bp["ls2"], "gamma"))]
    for i in range(4):
        out += conv(f"depth_head.projects.{i}", head["projects"][i])
        out.append((f"depth_head.scratch.layer{i + 1}_rn.weight",
                    (head["layer_rn"][i], "weight")))
    # resize_layers 0 / 1 are ConvTranspose2d ([I, O, k, k]); 3 a Conv2d
    for key, j in (("resize0", 0), ("resize1", 1), ("resize3", 3)):
        out += conv(f"depth_head.resize_layers.{j}", head[key])
    for i in range(4):
        pre = f"depth_head.scratch.refinenet{i + 1}."
        blk = head["refinenet"][i]
        out += conv(pre + "out_conv", blk["out_conv"])
        for j, rcu in ((1, "rcu1"), (2, "rcu2")):
            out += conv(pre + f"resConfUnit{j}.conv1", blk[rcu]["conv1"])
            out += conv(pre + f"resConfUnit{j}.conv2", blk[rcu]["conv2"])
    out += conv("depth_head.scratch.output_conv1", head["out_conv1"])
    out += conv("depth_head.scratch.output_conv2.0", head["out_conv2a"])
    out += conv("depth_head.scratch.output_conv2.2", head["out_conv2b"])
    return out


def dav2_state_dict(params: dict):
    """The port's tree under the release file's names (the inverse of
    `load_dav2`'s map), for files the loader reads."""
    return {name: sub[key] for name, (sub, key) in _release_names(params)}


def load_dav2(path: str, cfg: Optional[DAv2Config] = None,
              verbose: bool = True, device="cuda"):
    """The name map of `depth_anything_v2_vitl.pth` onto (params on
    `device`, cfg). The file is read (`torch.load(weights_only=True)`)
    before a tree is built; a tensor of another shape, or a low coverage,
    raises through `check_mapping(strict=True)`, as JAX's. `cfg` defaults
    to the Large geometry (`DAv2Config()`)."""
    from flexam_tpu_torch.io.verify_load import check_mapping
    cfg = cfg or DAv2Config()
    dev = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items() if torch.is_tensor(v)}
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dav2_init(gen, cfg, dev)
    report = {"loaded": [], "missing": [], "unused": list(sd)}

    for name, (dst, key) in _release_names(params):
        if name not in sd:
            report["missing"].append(name)
            continue
        a, cur = sd[name], dst[key]
        if tuple(a.shape) != tuple(cur.shape):
            report["missing"].append(f"{name} (shape {tuple(a.shape)} vs "
                                     f"{tuple(cur.shape)})")
            continue
        dst[key] = a.to(dev, copy=True).float()
        report["loaded"].append(name)
        report["unused"].remove(name)
    check_mapping(report, name="depth_anything_v2", strict=True,
                  quiet=not verbose)
    return params, cfg
