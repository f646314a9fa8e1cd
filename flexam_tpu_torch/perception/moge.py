"""MoGe-2: monocular geometry (point map, depth, mask, intrinsics).

Port of `flexam_tpu/perception/moge.py`, in torch ops on the caller's
device (CUDA unless the caller asks for the CPU). The reference's
image-input path runs `MoGeModel.from_pretrained(...).infer(img [3, H, W]
in 0..1)` -> {"points" [H, W, 3], "depth" [H, W], "mask" [H, W],
"intrinsics" [3, 3] (normalized)}; the MoGe source is absent from the
reference snapshot, so, as in JAX, this is the published architecture
family behind that call surface:

  * the DINOv2 ViT-L/14 encoder of the UniDepth port
    (`perception.unidepth.encode_image`) over its depth slices;
  * a convolutional upsampling head: a point map whose z is known up to a
    global shift, mask logits, normals, and a log metric scale from the
    last slice's cls token;
  * camera recovery (`recover_focal_shift`): focal length and z-shift
    solved from the point map itself, host numpy, JAX's code unchanged.

The mask is `resized logits > 0`, and only the points inside it feed the
solver. Conv weights are torch's [O, I, kh, kw] (`io/convert.py` turns
JAX's HWIO kernels into it); every attention is `core.attention.
exact_attention`. `load_moge` maps a checkpoint by shape signature, raises
below its coverage threshold unless FLEXAM_MOGE_BESTEFFORT=1, and reads
`model.pt` before `model.safetensors` in a directory, as JAX's does.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from flexam_tpu_torch.core.layers import linear, linear_init
from flexam_tpu_torch.device import resolve_device
from flexam_tpu_torch.perception.unidepth import (UniDepthV2Config, _conv2d,
                                                  _conv_init, _gelu, _ln,
                                                  _ln_init, _resize_bilinear,
                                                  encode_image, encoder_init)


@dataclass(frozen=True)
class MoGeConfig:
    # encoder (DINOv2 ViT-L/14 like the vitl checkpoints)
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    num_register_tokens: int = 4
    output_idx: Tuple[int, ...] = (5, 12, 18, 24)
    pretrain_img_size: int = 518
    # head
    head_dim: int = 256
    num_upsamples: int = 2          # grid -> 4x grid, then resize to H,W
    predict_normal: bool = True     # the "-normal" variants
    # infer-time pixel budget (multiple-of-14 resize like the encoder)
    pixels_min: int = 200_000
    pixels_max: int = 600_000

    def encoder_cfg(self) -> UniDepthV2Config:
        return UniDepthV2Config(
            patch_size=self.patch_size, embed_dim=self.embed_dim,
            depth=self.depth, num_heads=self.num_heads,
            num_register_tokens=self.num_register_tokens,
            output_idx=self.output_idx,
            pretrain_img_size=self.pretrain_img_size)


# ---------------------------------------------------------------------------
# head
# ---------------------------------------------------------------------------


def head_init(gen, cfg: MoGeConfig, device) -> dict:
    d = cfg.head_dim
    out_ch = 3 + 1 + (3 if cfg.predict_normal else 0)   # points+mask(+normal)
    low = d // (2 ** cfg.num_upsamples)
    p = {
        "proj": [linear_init(gen, cfg.embed_dim, d, device=device)
                 for _ in cfg.output_idx],
        "level_w": torch.zeros((len(cfg.output_idx),), device=device),
        "ups": [],
        "out_norm": _ln_init(low, device),
        "out_conv": _conv_init(gen, 3, 3, low, out_ch, device),
        "scale_head": linear_init(gen, cfg.embed_dim, 1, device=device),
    }
    cur = d
    for _ in range(cfg.num_upsamples):
        p["ups"].append({
            "conv1": _conv_init(gen, 3, 3, cur, cur, device),
            "conv2": _conv_init(gen, 3, 3, cur, cur // 2, device),
        })
        cur //= 2
    return p


def run_head(p: dict, feats, clss, out_hw, cfg: MoGeConfig):
    """feats: per-slice [B, h, w, C] -> (raw point map [B, H, W, 3],
    mask logits [B, H, W], normal [B, H, W, 3] | None, log-scale [B])."""
    w = torch.softmax(p["level_w"], dim=0)
    x = sum(w[i] * linear(f, p["proj"][i]) for i, f in enumerate(feats))
    for up in p["ups"]:
        x = _gelu(_conv2d(x, up["conv1"]))
        x = _conv2d(x, up["conv2"])
        _, h, ww, _ = x.shape
        x = _resize_bilinear(x, (2 * h, 2 * ww))
    x = _resize_bilinear(x, out_hw)
    x = _ln(x, p["out_norm"])
    out = _conv2d(x, p["out_conv"])
    pts = out[..., :3].float()
    # z parameterized positive via exp on the 3rd channel (the solver
    # resolves the shift)
    pts = torch.cat([pts[..., :2], torch.exp(pts[..., 2:].clamp(-8, 8))],
                    dim=-1)
    mask_logits = out[..., 3].float()
    normal = None
    if cfg.predict_normal:
        n = out[..., 4:7].float()
        normal = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(
            1e-6)
    log_scale = linear(clss[-1][:, 0], p["scale_head"]).float()[..., 0]
    return pts, mask_logits, normal, log_scale


def moge_init(gen, cfg: MoGeConfig, device="cuda") -> dict:
    device = resolve_device(device)
    return {"encoder": encoder_init(gen, cfg.encoder_cfg(), device),
            "head": head_init(gen, cfg, device)}


def forward(params, x, out_hw, cfg: MoGeConfig):
    """x [B, H, W, 3] normalized to [-1, 1] at the network size -> the
    head's (points, mask logits, normal, log-scale)."""
    feats, clss = encode_image(params["encoder"], x, cfg.encoder_cfg())
    return run_head(params["head"], feats, clss, out_hw, cfg)


# ---------------------------------------------------------------------------
# camera recovery: focal + z-shift from the affine-invariant point map
# ---------------------------------------------------------------------------


def recover_focal_shift(points: np.ndarray, mask: Optional[np.ndarray],
                        iters: int = 48) -> Tuple[float, float]:
    """MoGe's camera recovery: the net's point map (x, y, z) is correct up
    to a global z-shift dz; the true camera satisfies
        x / (z + dz) = (u - cx) / f,   y / (z + dz) = (v - cy) / f
    over the pixel grid in NORMALIZED image coords. For a candidate dz
    the optimal 1/f is closed-form least squares; dz is found by
    golden-section search on the residual. Returns (focal, shift) with
    focal normalized by the half image diagonal-ish convention below
    (we keep everything in the same normalized units the caller uses).

    Exact on noiseless pinhole data (tested)."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    h, w = points.shape[:2]
    # normalized pixel grid, origin at the principal point (center),
    # scaled so the longer side spans [-1, 1] — MoGe's uv convention
    s = max(h, w) / 2.0
    us = (np.arange(w) + 0.5 - w / 2.0) / s
    vs = (np.arange(h) + 0.5 - h / 2.0) / s
    gu, gv = np.meshgrid(us, vs, indexing="xy")
    uv = np.stack([gu.reshape(-1), gv.reshape(-1)], axis=1)
    m = (np.ones(len(pts), bool) if mask is None
         else np.asarray(mask).reshape(-1).astype(bool))
    m &= np.isfinite(pts).all(axis=1)
    pts, uv = pts[m], uv[m]
    if len(pts) < 8:
        return 1.0, 0.0
    xy = pts[:, :2].reshape(-1)
    z = pts[:, 2]
    zmin = float(z.min())

    def residual(dz):
        denom = np.repeat(z + dz, 2)
        a = uv.reshape(-1) * denom                    # (u,v)*(z+dz)
        s_opt = float(a @ xy) / max(float(a @ a), 1e-12)   # = 1/f
        r = s_opt * a - xy
        return float(r @ r), 1.0 / max(s_opt, 1e-9)

    # golden-section over dz in (zmin*(-1)+eps, +range): z+dz must stay > 0
    lo = -zmin + 1e-6
    hi = -zmin + 10.0 * max(float(z.max() - zmin), 1e-3) + 1.0
    gr = (math.sqrt(5.0) - 1.0) / 2.0
    a_, b_ = lo, hi
    c_ = b_ - gr * (b_ - a_)
    d_ = a_ + gr * (b_ - a_)
    fc, _ = residual(c_)
    fd, _ = residual(d_)
    for _ in range(iters):
        if fc < fd:
            b_, d_, fd = d_, c_, fc
            c_ = b_ - gr * (b_ - a_)
            fc, _ = residual(c_)
        else:
            a_, c_, fc = c_, d_, fd
            d_ = a_ + gr * (b_ - a_)
            fd, _ = residual(d_)
    dz = (a_ + b_) / 2.0
    _, f = residual(dz)
    return float(f), float(dz)


# ---------------------------------------------------------------------------
# model wrapper
# ---------------------------------------------------------------------------


class MoGeModel:
    """`MoGeModel.infer(img)` drop-in: img [3, H, W] (or [H, W, 3]) in
    0..1 -> {"points" [H,W,3] camera-frame metric points, "depth" [H,W],
    "mask" [H,W] bool, "intrinsics" [3,3] NORMALIZED (fx, cx in units of
    width / height like MoGe), "normal" [H,W,3] when configured}, numpy.
    The params live on `device`."""

    def __init__(self, cfg: Optional[MoGeConfig] = None, params=None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg or MoGeConfig()
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = moge_init(gen, self.cfg, self.device)
        self.params = params
        self.load_report = None    # set by load_moge
        self.load_ok = False
        self.last_info = {}        # network input, mask logits, focal,
                                   # shift and scale of the last call

    def to(self, *a, **k):
        return self

    def eval(self):
        return self

    @classmethod
    def from_pretrained(cls, path: str, cfg: Optional[MoGeConfig] = None,
                        device="cuda"):
        return load_moge(path, cfg, device=device)

    def network_hw(self, h: int, w: int) -> Tuple[int, int]:
        """The encoder's input for an h x w image: the pixel budget's
        resize, snapped to multiples of the patch."""
        cfg = self.cfg
        n = h * w
        target = min(cfg.pixels_max, max(cfg.pixels_min, n))
        f = (target / n) ** 0.5
        ps = cfg.patch_size
        return (max(ps, int(round(h * f / ps)) * ps),
                max(ps, int(round(w * f / ps)) * ps))

    @torch.no_grad()
    def infer(self, img, **kw):
        cfg = self.cfg
        if torch.is_tensor(img):
            img = img.detach().cpu().numpy()
        arr = np.asarray(img, np.float32)
        if arr.ndim == 3 and arr.shape[0] == 3:
            arr = arr.transpose(1, 2, 0)
        h, w, _ = arr.shape
        # contract: 0..1 input, like the reference's `moge.infer(first_
        # frame)`; no max() heuristic (it would mis-scale dark frames)
        nh, nw = self.network_hw(h, w)
        x = torch.from_numpy(np.ascontiguousarray((arr - 0.5) / 0.5))[None]
        x = _resize_bilinear(x.to(self.device), (nh, nw))
        pts, mask_logits, normal, log_scale = forward(
            self.params, x, (nh, nw), cfg)
        pts = _resize_bilinear(pts, (h, w))[0].cpu().numpy()
        logits = _resize_bilinear(mask_logits[..., None],
                                  (h, w))[0, ..., 0].cpu().numpy()
        mask = logits > 0.0
        focal, dz = recover_focal_shift(pts, mask)
        scale = float(np.exp(log_scale.cpu().numpy())[0])
        self.last_info = {"network_hw": (nh, nw), "mask_logits": logits,
                          "focal": focal, "shift": dz, "scale": scale}
        points = pts.copy()
        points[..., 2] += dz
        points *= scale
        # normalized intrinsics in MoGe's convention: fx normalized by
        # width, fy by height, principal point at the center
        s = max(h, w) / 2.0
        fx = focal * s / w
        fy = focal * s / h
        intr = np.asarray([[fx, 0, 0.5], [0, fy, 0.5], [0, 0, 1]],
                          np.float32)
        out = {"points": points.astype(np.float32),
               "depth": points[..., 2].astype(np.float32),
               "mask": mask,
               "intrinsics": intr}
        if normal is not None:
            out["normal"] = _resize_bilinear(normal, (h, w))[0].cpu().numpy(
            ).astype(np.float32)
        return out


def load_moge(path: str, cfg: Optional[MoGeConfig] = None,
              coverage_threshold: float = 0.9, device="cuda") -> MoGeModel:
    """Best-effort checkpoint load onto `device`: the shape-signature
    mapping of `load_densetrack3d` (the MoGe source is absent from the
    reference snapshot, so exact names are unknowable; unmatched tensors
    are reported).

    A mapping below `coverage_threshold` RAISES (per-module table printed
    first) instead of silently serving scrambled weights; set
    FLEXAM_MOGE_BESTEFFORT=1 to opt into a partial load."""
    from flexam_tpu_torch.io.verify_load import check_mapping
    from flexam_tpu_torch.perception.densetrack3d import (
        map_torch_state_dict, read_state_dict)
    sd = read_state_dict(path, ("model.pt", "model.safetensors",
                                "pytorch_model.bin"))
    model = MoGeModel(cfg, device=device)
    model.params, report = map_torch_state_dict(model.params, sd)
    model.load_report = report
    print(f"moge: mapped {len(report['loaded'])} tensors, "
          f"{len(report['missed'])} unmatched (best-effort)")
    model.load_ok = check_mapping(report, quiet=True,
                                  threshold=coverage_threshold)
    if not model.load_ok:
        check_mapping(report, name=f"moge[{path}]",
                      threshold=coverage_threshold)
        if os.environ.get("FLEXAM_MOGE_BESTEFFORT") != "1":
            raise ValueError(
                f"moge checkpoint {path} mapped below "
                f"{coverage_threshold:.0%} coverage — refusing to serve "
                "scrambled weights (set FLEXAM_MOGE_BESTEFFORT=1 to "
                "accept the partial load)")
        print("WARNING: FLEXAM_MOGE_BESTEFFORT=1 — proceeding with a "
              "LOW-COVERAGE moge load; unmatched modules stay random")
    return model
