"""VGGT: the alternating-attention multi-view geometry model.

Port of `flexam_tpu/perception/vggt.py`, in torch ops on the caller's
device (CUDA unless the caller asks for the CPU). The reference's
video-input camera path runs `VGGT.from_pretrained("facebook/VGGT-1B")`
and consumes three members:

    tokens_list, ps_idx = model.aggregator(video [1, T, 3, 518, W])
    pose_enc = model.camera_head(tokens_list)[-1]        # [B, T, 9]
    extr, intr = pose_encoding_to_extri_intri(pose_enc, (H, W))
    depth, conf = model.depth_head(tokens_list, video, ps_idx)

The VGGT source is absent from the reference snapshot, so, as in JAX, this
is the published architecture family behind that surface: the DINOv2
patchifier of the UniDepth port; per frame a camera token and register
tokens, the FIRST frame's distinct (it pins the reference view: the model
is deliberately not permutation equivariant, unlike Pi3); an aggregator of
alternating frame-wise and global attention whose per-pair outputs feed
the heads; an iterative camera head refining an absT + quat + FoV
encoding from a zero-initialised last layer, seeded at the identity
rotation and fov 0.9 (a random VGGT emits exactly the identity rotation
and zero translation); a DPT-style depth head over tapped layers.

The global attention of a 49-frame 512x896 clip sees 38,318 tokens at
head dim 64: `core.attention.exact_attention` over query chunks
(`attention_plain`'s 2,048 rows), as JAX's XLA attention. The checkpoint
mapper is the shape-signature one of `load_densetrack3d`, coverage-gated;
a directory resolves to `model.safetensors` first. `vggt_video_poses`
resizes as OpenCV's INTER_CUBIC does (`utils.media.resize_frames_cubic`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flexam_tpu_torch.core.layers import linear, linear_init
from flexam_tpu_torch.device import resolve_device
from flexam_tpu_torch.perception.unidepth import (IMAGENET_MEAN,
                                                  IMAGENET_STD,
                                                  UniDepthV2Config,
                                                  _attn_block,
                                                  _attn_block_init, _gelu,
                                                  _ln, _ln_init,
                                                  encode_image, encoder_init)


@dataclass(frozen=True)
class VGGTConfig:
    # DINOv2 patchifier (shared family with the UniDepth/MoGe/Pi3 ports)
    patch_size: int = 14
    embed_dim: int = 1024
    enc_depth: int = 24
    enc_heads: int = 16
    num_register_tokens: int = 4
    pretrain_img_size: int = 518
    # aggregator: alternating frame/global attention pairs
    agg_dim: int = 1024
    agg_depth: int = 24
    agg_heads: int = 16
    mlp_expansion: int = 4
    n_special: int = 5              # 1 camera + 4 register tokens / frame
    # camera head
    cam_iters: int = 4
    cam_heads: int = 8
    # depth head taps (indices into tokens_list)
    depth_taps: Tuple[int, ...] = (4, 11, 17, 23)
    depth_features: int = 128
    compute: str = "float32"

    def encoder_cfg(self) -> UniDepthV2Config:
        return UniDepthV2Config(
            patch_size=self.patch_size, embed_dim=self.embed_dim,
            depth=self.enc_depth, num_heads=self.enc_heads,
            num_register_tokens=self.num_register_tokens,
            output_idx=(self.enc_depth,),
            pretrain_img_size=self.pretrain_img_size)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute == "bfloat16" else torch.float32


def vggt_init(gen, cfg: VGGTConfig, device="cuda") -> dict:
    device = resolve_device(device)
    d = cfg.agg_dim

    def tokens(n):
        return torch.randn((1, 1, n, d), generator=gen, device=device) * 0.02

    p = {
        "encoder": encoder_init(gen, cfg.encoder_cfg(), device),
        "proj_in": linear_init(gen, cfg.embed_dim, d, device=device),
        # learnable special tokens; the FIRST-frame variants differ so the
        # model can pin the reference view (non-equivariance by design)
        "camera_token": tokens(1),
        "camera_token_first": tokens(1),
        "register_token": tokens(cfg.n_special - 1),
        "register_token_first": tokens(cfg.n_special - 1),
        "agg_frame": [
            _attn_block_init(gen, d, cfg.mlp_expansion, cfg.agg_heads, 0.0,
                             device) for _ in range(cfg.agg_depth)],
        "agg_global": [
            _attn_block_init(gen, d, cfg.mlp_expansion, cfg.agg_heads, 0.0,
                             device) for _ in range(cfg.agg_depth)],
    }
    # camera head: iterative trunk over the per-frame camera tokens
    p["cam_norm"] = _ln_init(d, device)
    p["cam_embed"] = linear_init(gen, 9, d, device=device)
    p["cam_trunk"] = [
        _attn_block_init(gen, d, cfg.mlp_expansion, cfg.cam_heads, 0.0,
                         device) for _ in range(cfg.cam_iters)]
    p["cam_fc1"] = linear_init(gen, d, d, device=device)
    p["cam_fc2"] = {"weight": torch.zeros((9, d), device=device),
                    "bias": torch.zeros((9,), device=device)}
    # depth head: per-tap projection + fused refinement
    f = cfg.depth_features
    p["depth_proj"] = [linear_init(gen, d, f, device=device)
                       for _ in cfg.depth_taps]
    p["depth_conv1"] = linear_init(gen, f, f, device=device)
    p["depth_conv2"] = linear_init(
        gen, f, cfg.patch_size * cfg.patch_size * 2, device=device)
    return p


def _prep(imgs: torch.Tensor, dtype) -> torch.Tensor:
    x = imgs.permute(0, 1, 3, 4, 2)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device, dtype=x.dtype)
    std = torch.as_tensor(IMAGENET_STD, device=x.device, dtype=x.dtype)
    return ((x - mean) / std).to(dtype)


def vggt_aggregator(params: dict, cfg: VGGTConfig, imgs: torch.Tensor
                    ) -> Tuple[List[torch.Tensor], int]:
    """imgs [B, T, 3, H, W] 0..1 -> (tokens_list — one [B, T, N, D] per
    alternating-attention pair, N = n_special + patches —,
    patch_start_idx)."""
    b, t, _, h, w = imgs.shape
    x = _prep(imgs, cfg.dtype).reshape(b * t, h, w, 3)
    feats, _ = encode_image(params["encoder"], x, cfg.encoder_cfg())
    f = feats[-1]
    h0, w0 = f.shape[1], f.shape[2]
    ptoks = h0 * w0
    tok = linear(f.reshape(b * t, ptoks, cfg.embed_dim), params["proj_in"])
    tok = tok.reshape(b, t, ptoks, cfg.agg_dim)

    def expand(first, rest, n):
        first = first.to(tok.dtype).expand(b, 1, n, cfg.agg_dim)
        if t == 1:
            return first
        rest = rest.to(tok.dtype).expand(b, t - 1, n, cfg.agg_dim)
        return torch.cat([first, rest], dim=1)

    cam = expand(params["camera_token_first"], params["camera_token"], 1)
    reg = expand(params["register_token_first"], params["register_token"],
                 cfg.n_special - 1)
    tok = torch.cat([cam, reg, tok], dim=2)             # [B, T, N, D]
    n = tok.shape[2]

    tokens_list = []
    for fp, gp in zip(params["agg_frame"], params["agg_global"]):
        flat = tok.reshape(b * t, n, cfg.agg_dim)
        flat = _attn_block(fp, flat, cfg.agg_heads)            # per frame
        flat = flat.reshape(b, t * n, cfg.agg_dim)
        flat = _attn_block(gp, flat, cfg.agg_heads)            # global
        tok = flat.reshape(b, t, n, cfg.agg_dim)
        tokens_list.append(tok)
    return tokens_list, cfg.n_special


def vggt_camera_head(params: dict, cfg: VGGTConfig,
                     tokens_list: List[torch.Tensor]) -> List[torch.Tensor]:
    """Iterative refinement over the camera tokens -> list of pose
    encodings [B, T, 9] (absT(3) + quat wxyz(4) + fov(2)); the reference
    consumes `[-1]`. Initialized to the identity pose: the quat seed
    (1, 0, 0, 0) and a zero last layer."""
    cam = tokens_list[-1][:, :, 0]                       # [B, T, D]
    cam = _ln(cam, params["cam_norm"])
    b, t, _ = cam.shape
    enc = torch.zeros((b, t, 9), dtype=cam.dtype, device=cam.device)
    enc[..., 3] = 1.0                                    # identity quat
    # seed fov ~51 deg so identity-init intrinsics stay finite
    # (fov=0 -> fx=inf in pose_encoding_to_extri_intri)
    enc[..., 7:9] = 0.9
    outs = []
    for i in range(cfg.cam_iters):
        h = cam + linear(enc, params["cam_embed"])
        h = _attn_block(params["cam_trunk"][i], h, cfg.cam_heads)
        delta = linear(_gelu(linear(h, params["cam_fc1"])),
                       params["cam_fc2"])
        enc = enc + delta
        outs.append(enc.float())
    return outs


def vggt_depth_head(params: dict, cfg: VGGTConfig,
                    tokens_list: List[torch.Tensor], imgs: torch.Tensor,
                    patch_start_idx: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DPT-style fusion of the tapped aggregator layers -> per-pixel
    (depth [B, T, H, W, 1], conf [B, T, H, W]) like the reference's
    `depth_head(aggregated_tokens_list, images, ps_idx)`."""
    b, t, _, h, w = imgs.shape
    ps = cfg.patch_size
    h0, w0 = h // ps, w // ps
    taps = [tokens_list[min(i, len(tokens_list) - 1)]
            for i in cfg.depth_taps]
    acc = None
    for proj, tap in zip(params["depth_proj"], taps):
        ft = linear(tap[:, :, patch_start_idx:], proj)   # [B,T,P,f]
        acc = ft if acc is None else acc + ft
    acc = _gelu(linear(acc, params["depth_conv1"]))
    out = linear(acc, params["depth_conv2"])             # [B,T,P,ps*ps*2]
    out = out.reshape(b, t, h0, w0, ps, ps, 2)
    out = out.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t, h, w, 2)
    depth = F.softplus(out[..., :1]).float()
    conf = torch.sigmoid(out[..., 1]).float()
    return depth, conf


class VGGT:
    """Reference call surface (`demo.py:310-321`); the params live on
    `device`."""

    def __init__(self, cfg: Optional[VGGTConfig] = None, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg or VGGTConfig()
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = vggt_init(gen, self.cfg, self.device)
        self.load_report = None
        self.load_ok = False

    def to(self, *a, **k):
        return self

    def eval(self):
        return self

    @classmethod
    def from_pretrained(cls, name_or_path: str = "facebook/VGGT-1B",
                        cfg: Optional[VGGTConfig] = None,
                        device="cuda") -> "VGGT":
        """A local path, else FLEXAM_VGGT_CKPT; never the network."""
        path = None
        if os.path.exists(str(name_or_path)):
            path = str(name_or_path)
        elif os.environ.get("FLEXAM_VGGT_CKPT"):
            path = os.environ["FLEXAM_VGGT_CKPT"]
        if path:
            return load_vggt(path, cfg=cfg, device=device)
        print("WARNING: no VGGT weights found (set FLEXAM_VGGT_CKPT) — "
              "random-weight VGGT emits near-identity poses; the "
              "track-based Kabsch solver is the no-checkpoint fallback")
        return cls(cfg, device=device)

    def _imgs(self, imgs) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(imgs, np.float32), device=self.device)
        return x[None] if x.dim() == 4 else x

    @torch.no_grad()
    def aggregator(self, imgs) -> Tuple[list, int]:
        toks, ps = vggt_aggregator(self.params, self.cfg, self._imgs(imgs))
        return list(toks), ps

    @torch.no_grad()
    def camera_head(self, tokens_list) -> List[np.ndarray]:
        outs = vggt_camera_head(self.params, self.cfg, tokens_list)
        return [o.cpu().numpy() for o in outs]

    @torch.no_grad()
    def depth_head(self, tokens_list, imgs, patch_start_idx: int):
        d, c = vggt_depth_head(self.params, self.cfg, tokens_list,
                               self._imgs(imgs), patch_start_idx)
        return d.cpu().numpy(), c.cpu().numpy()


def load_vggt(path: str, model: Optional[VGGT] = None,
              coverage_threshold: float = 0.9,
              cfg: Optional[VGGTConfig] = None, device="cuda") -> VGGT:
    """Shape-signature checkpoint mapping with coverage gating (the policy
    of load_densetrack3d/load_moge/load_pi3), into `model` or a new VGGT
    of `cfg` on `device`. The file is read before a model is built."""
    from flexam_tpu_torch.io.verify_load import check_mapping
    from flexam_tpu_torch.perception.densetrack3d import (
        map_torch_state_dict, read_state_dict)

    sd = read_state_dict(path, ("model.safetensors", "model.pt",
                                "pytorch_model.bin"))
    model = model or VGGT(cfg, device=device)
    model.params, report = map_torch_state_dict(model.params, sd)
    model.load_report = report
    model.load_ok = check_mapping(report, quiet=True,
                                  threshold=coverage_threshold)
    print(f"vggt: mapped {len(report['loaded'])} tensors, "
          f"{len(report['missed'])} unmatched (best-effort)")
    if not model.load_ok:
        check_mapping(report, name=f"vggt[{path}]",
                      threshold=coverage_threshold)
        print("WARNING: vggt checkpoint mapping is LOW-COVERAGE — "
              "unmatched modules stay at random init")
    return model


def vggt_video_poses(video: np.ndarray, model: Optional[VGGT] = None,
                     device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """[T, H, W, 3] (or [T, 3, H, W]) 0..1 -> (extr [T, 3, 4],
    intr [T, 3, 3]) — the reference preprocessing chain (`demo.py:
    297-319`): resize to width 518 (OpenCV's bicubic, height snapped to
    /14, center-cropped to <= 518), aggregator -> camera head ->
    pose_encoding_to_extri_intri. Without `model`, `VGGT.from_pretrained`
    on `device`."""
    from flexam_tpu_torch.perception.poses import pose_encoding_to_extri_intri
    from flexam_tpu_torch.utils.media import resize_frames_cubic

    v = np.asarray(video, np.float32)
    if v.ndim == 4 and v.shape[1] == 3:
        v = v.transpose(0, 2, 3, 1)
    t, h, w, _ = v.shape
    new_w = 518
    new_h = round(h * (new_w / w) / 14) * 14
    frames = resize_frames_cubic(v, (new_h, new_w))
    if new_h > 518:
        y0 = (new_h - 518) // 2
        frames = frames[:, y0:y0 + 518]
    model = model or VGGT.from_pretrained(device=device)
    imgs = frames.transpose(0, 3, 1, 2)[None]            # [1,T,3,H,W]
    toks, _ = model.aggregator(imgs)
    enc = model.camera_head(toks)[-1]
    return pose_encoding_to_extri_intri(enc, frames.shape[1:3])
